"""One served request, worked out by the plain fp32 reference.

ids and a voice mix → 24 kHz waveform, as the published inference does
it: the text encoder and duration predictor at the request's own length
(no text bucket), durations exp(logw) − 2 times the voice's duration
correction, rounded with a floor of one fine frame; the prior expanded by
the durations at hop 128 and averaged down to hop 256; the midpoint ODE
from mu + the seeded noise row through the U-Net with GroupNorm statistics
over the valid frames; denormalise; Vocos and its ISTFT; peak-normalise to
0.95 only when it clips; cut to the valid frames; trim trailing silence.

The served system runs Vocos on a mel padded to its mel bucket with the
corpus mean, and the ConvNeXt stack reaches 27 frames across, so the last
frames of a waveform depend on how much padding follows them.  ``waveforms``
therefore returns one waveform per padding the served system can use: the
smallest mel bucket of its published ladder that holds the request, and a
padding longer than the stack reaches (every larger bucket gives that
one).  The judge takes the nearer.

The number judged is ``audio_rel_err``, the waveforms' relative L2
distance.  ``audio_gap_db``, a log-mel distance, is kept as a diagnostic:
it weighs every mel band alike, so a band the reference leaves almost
silent (a low band with random weights) turns a tiny absolute error into
decibels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import MatchaTTS, Vocos, sequence_mask

LONG_PAD = 64  # coarse frames of padding beyond Vocos' 27-frame reach
TOP_DB = 80.0  # log-mel floor below the loudest bin


def build(cfg: dict, params: dict, vparams: dict, device) -> tuple[MatchaTTS, Vocos]:
    """The reference modules in float32 on ``device`` with the given weights."""
    model = MatchaTTS(cfg["model"]).to(device)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    vocos = Vocos(cfg["vocos"]).to(device)
    vocos.load_state_dict({k: v.float() for k, v in vparams.items()})
    return model.eval(), vocos.eval()


def scale_correction(cfg: dict, voice_mix) -> float:
    table = cfg["serving"]["scale_corrections"]
    total = sum(w for _, w in voice_mix) or 1.0
    return sum(w * table.get(str(s), 1.0) for s, w in voice_mix) / total


def downsample_time(x):
    t = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1 + t % 2))
    return (xp[:, 0:-2:2] + xp[:, 1:-1:2] + xp[:, 2::2]) / 3.0


def trim_trailing_silence(audio: np.ndarray, sample_rate: int, threshold_db: float = -60.0) -> np.ndarray:
    window = int(0.01 * sample_rate)
    if len(audio) < window:
        return audio
    n_win = len(audio) // window
    rms = np.sqrt(np.mean(np.square(audio[: n_win * window].reshape(n_win, window)), axis=1))
    loud = np.flatnonzero(rms >= 10.0 ** (threshold_db / 20.0))
    trailing = n_win if loud.size == 0 else n_win - 1 - int(loud[-1])
    return audio if trailing == 0 else audio[: -trailing * window]


@torch.no_grad()
def mel(model: MatchaTTS, cfg: dict, ids, voice_mix, noise_row: torch.Tensor):
    """Denormalised mel (L, n_feats) of the request's L coarse frames."""
    m = cfg["model"]
    dev = noise_row.device
    enc_tab = model.speaker_embeddings_enc.weight
    dur_tab = model.speaker_embeddings_dur.weight
    spk_enc = sum(w * enc_tab[s] for s, w in voice_mix)[None]
    spk_dur = sum(w * dur_tab[s] for s, w in voice_mix)[None]
    x = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)[None]
    x_mask = torch.ones(x.shape, device=dev)
    mu_x, logw = model.encoder(x, x_mask, spk_enc, spk_dur)
    scale = scale_correction(cfg, voice_mix)
    durations = torch.clamp(torch.round((torch.exp(logw) - 2.0) * scale), min=1.0)[0]
    fine = max(int(durations.sum()), 2)
    coarse = (fine + 1) // 2
    t = coarse + coarse % 2  # the U-Net halves time once
    token = torch.repeat_interleave(torch.arange(x.shape[1], device=dev), durations.long())
    mu_fine = torch.zeros((1, 2 * t, m["n_feats"]), device=dev)
    mu_fine[0, : token.numel()] = mu_x[0, token]
    mu_y = downsample_time(mu_fine)
    y_mask = sequence_mask(torch.tensor([coarse], device=dev), t).float()
    z = (mu_y + noise_row[:t][None]) * y_mask[..., None]
    steps, est = cfg["serving"]["n_timesteps"], model.decoder.estimator
    grid = torch.linspace(0.0, 1.0, steps + 1, device=dev)
    for i in range(steps):  # midpoint
        tt, dt = grid[i], grid[i + 1] - grid[i]
        k1 = est(z, y_mask, mu_y, tt)
        z = z + dt * est(z + 0.5 * dt * k1, y_mask, mu_y, tt + 0.5 * dt)
    stats = m["data_statistics"]
    return (z[0, :coarse] * stats["mel_std"] + stats["mel_mean"]), coarse


def coarse_buckets(cfg: dict) -> list[int]:
    return [b // 2 for b in cfg["serving"]["mel_fine_buckets"]]


@torch.no_grad()
def waveforms(model, vocos, cfg: dict, ids, voice_mix, noise_row) -> list[np.ndarray]:
    """The request's waveform for each padding the served system can put
    after it (see the module doc), int16-quantised as a WAV carries it."""
    mel_l, coarse = mel(model, cfg, ids, voice_mix, noise_row)
    mean = cfg["model"]["data_statistics"]["mel_mean"]
    bucket = next(b for b in coarse_buckets(cfg) if b >= coarse)
    sr = cfg["vocos"]["sample_rate"]
    out = []
    for total in sorted({bucket, coarse + LONG_PAD}):
        padded = torch.full((1, total, mel_l.shape[1]), mean, device=mel_l.device)
        padded[0, :coarse] = mel_l
        wav = vocos(padded)
        peak = wav.abs().amax(dim=-1, keepdim=True)
        wav = torch.where(peak > 1.0, wav / peak * 0.95, wav)[0]
        wav = wav[: max((coarse - 1) * cfg["vocos"]["hop_length"], 0)].cpu().numpy()
        wav = trim_trailing_silence(wav, sr)
        out.append((np.clip(wav, -1, 1) * 32767).astype(np.int16).astype(np.float32) / 32767.0)
    return out


def log_mel(wav: np.ndarray, n: int, sr: int = 24000, n_fft: int = 1024, hop: int = 256,
            n_mels: int = 100) -> np.ndarray:
    """(frames, n_mels) power log-mel in dB of ``wav`` zero-padded to ``n``
    samples; triangular mel filters from 0 to sr/2 (HTK mel scale)."""
    x = np.zeros(n + n_fft, np.float64)
    x[n_fft // 2: n_fft // 2 + len(wav)] = wav
    frames = 1 + n // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    power = np.abs(np.fft.rfft(x[idx] * win, axis=-1)) ** 2
    hz = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(0, 2595 * math.log10(1 + (sr / 2) / 700), n_mels + 2)
    edges = 700 * (10 ** (mel_pts / 2595) - 1)
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    fb = np.maximum(0, np.minimum((hz - lo) / (mid - lo), (hi - hz) / (hi - mid)))
    return 10.0 * np.log10(np.maximum(power @ fb.T, 1e-10))


def audio_rel_err(served: np.ndarray, ref: np.ndarray) -> float:
    """‖served − ref‖ / ‖ref‖ over the longer of the two waveforms (the
    shorter zero-padded, so a missing or extra stretch of audio counts in
    full).  An energy-weighted distance: a band the reference leaves nearly
    silent adds its tiny absolute error, not a large ratio."""
    n = max(len(served), len(ref), 1)
    a, b = np.zeros(n), np.zeros(n)
    a[: len(served)], b[: len(ref)] = served, ref
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def audio_gap_db(served: np.ndarray, ref: np.ndarray, sr: int = 24000, top_db: float | None = TOP_DB) -> float:
    """Mean over frames of the RMS over mel bins of the log-mel difference,
    in dB, over the longer of the two waveforms (the shorter zero-padded,
    so a missing or extra stretch of audio counts in full).  Both log-mels
    are floored ``top_db`` below the reference's loudest bin, as a
    spectrogram is shown: bins deep in a spectral null carry no audible
    difference."""
    n = max(len(served), len(ref), 1)
    a, b = log_mel(served, n, sr), log_mel(ref, n, sr)
    if top_db is not None:
        floor = b.max() - top_db
        a, b = np.maximum(a, floor), np.maximum(b, floor)
    d = a - b
    return float(np.mean(np.sqrt(np.mean(d * d, axis=1))))
