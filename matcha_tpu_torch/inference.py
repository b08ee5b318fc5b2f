"""End-to-end synthesis: phoneme ids → 24 kHz waveform on the card.

PyTorch counterpart of ``matcha_tpu/inference.py`` with the same public
surface.  Two stages, the host choosing the mel bucket between them:

  stage A (text bucket):        ids → (mu_x, durations)
  stage B (text x mel bucket):  (mu_x, durations) → prior gather → CFM ODE
                                → denormalize → Vocos → peak-normalize

and the fused path, which runs both at a mel bucket predicted from the text
length and falls back to the two stages when the speech overflows it.
Buckets keep the JAX package's ladder, so the two synthesizers see the same
shapes.  Each result comes back to the host in one device→host copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no device on a host without CUDA, construction raises.

Fan-out (``mesh=[devices]``, the counterpart of the JAX synthesizer's data
mesh): one model and Vocos replica per device, each with its noise row and
CUDA stream.  A batch pads to the power-of-2 ladder and then to a device
multiple (a single request to one row per device, pad rows one token long);
each replica runs its contiguous block of rows from its own host thread,
and the rows come back gathered in order.  The path is host-bound, so
issuing the replicas from one thread would serialise them.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.models.flow_matching import seeded_synthesis_noise
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.utils.model_math import (
    denormalize,
    downsample_time,
    fix_len_compatibility,
    sequence_mask,
)
from matcha_tpu_torch.vocoder.vocos import Vocos, VocosConfig

SAMPLE_RATE = 24000
STD_RES_HOP_LENGTH = 256
HIGH_RES_HOP_LENGTH = 128

DEFAULT_ODE_SOLVER = "midpoint"
DEFAULT_NUM_STEPS = 4

# Voice registry: per-speaker duration scale corrections measured against
# ground truth after training (reference: matcha/inference.py:16-32).
VOICES: list[dict[str, Any]] = [
    {"id": "0", "lang": "en-us", "gender": "male", "name": "Kai", "scale_correction": 1.08},
    {"id": "1", "lang": "en-us", "gender": "female", "name": "Jane", "scale_correction": 1.05},
    {"id": "2", "lang": "en-us", "gender": "female", "name": "Aria", "scale_correction": 1.05},
    {"id": "3", "lang": "en-us", "gender": "female", "name": "Bella", "scale_correction": 1.03},
    {"id": "4", "lang": "en-gb", "gender": "male", "name": "Brian", "scale_correction": 1.08},
    {"id": "5", "lang": "en-gb", "gender": "male", "name": "Arthur", "scale_correction": 1.08},
    {"id": "6", "lang": "en-us", "gender": "female", "name": "Nicole", "scale_correction": 1.05},
    {"id": "7", "lang": "ro", "gender": "male", "name": "Emil", "scale_correction": 1.04},
    {"id": "8", "lang": "fr-fr", "gender": "female", "name": "Denise", "scale_correction": 1.05},
    {"id": "9", "lang": "fr-fr", "gender": "male", "name": "Henri", "scale_correction": 1.03},
    {"id": "10", "lang": "en-us", "gender": "male", "name": "Matthew", "scale_correction": 1.06},
    {"id": "11", "lang": "en-us", "gender": "male", "name": "Lewis", "scale_correction": 1.08},
    {"id": "12", "lang": "en-us", "gender": "male", "name": "Michael", "scale_correction": 1.03},
    {"id": "13", "lang": "it", "gender": "female", "name": "Isabella", "scale_correction": 1.07},
    {"id": "14", "lang": "it", "gender": "male", "name": "Marcello", "scale_correction": 1.07},
]

# serving pace clamp (reference: matcha/server.py:34-36): length_scale is
# clamped to [0.1, 2.0]
MIN_LENGTH_SCALE = 0.1
MAX_LENGTH_SCALE = 2.0
MAX_SCALE_CORRECTION = max(v["scale_correction"] for v in VOICES)

DEFAULT_TEXT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4000)
DEFAULT_MEL_FINE_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)


def voice_by_id(speaker_id: int | str) -> dict[str, Any]:
    sid = str(speaker_id)
    for v in VOICES:
        if v["id"] == sid:
            return v
    raise KeyError(f"Unknown voice id {speaker_id!r}")


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"Length {n} exceeds largest bucket {buckets[-1]}")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card; raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def strict_fp32(device: torch.device) -> None:
    """On the card, TF32 off for cuBLAS matmuls and cuDNN convolutions
    alike: the model's fp32 products (see models/layers.py) must be true
    fp32."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Several tensors → float32 numpy arrays in ONE device→host copy (none
    for none: a synthesizer without a vocoder pulls nothing)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].reshape(tuple(t.shape)))
        start += t.numel()
    return out


def _gather(blocks: list[np.ndarray]) -> np.ndarray:
    """Replicas' row blocks in order; a lone block as it is (no host copy)."""
    return blocks[0] if len(blocks) == 1 else np.concatenate(blocks)


@dataclass
class SynthesisResult:
    wav: np.ndarray                       # (n_samples,) float32 in [-1, 1]
    rtf: float                            # wall time / audio seconds produced
    latency_s: float = 0.0                # wall time of the producing call
    mel: np.ndarray | None = None         # (frames, n_mels) denormalized
    durations: np.ndarray | None = None   # (tokens,) fine frames
    encoder_wav: np.ndarray | None = None


def blended_scale_correction(voice_mix: Sequence[tuple[int, float]]) -> float:
    """Weight-blend the per-voice duration corrections across a mix
    (reference: matcha/server.py:111-114)."""
    total_w = sum(w for _, w in voice_mix) or 1.0
    blended = 0.0
    for spk, w in voice_mix:
        try:
            sc = voice_by_id(spk)["scale_correction"]
        except KeyError:
            sc = 1.0
        blended += w * sc
    return blended / total_w


def trim_trailing_silence(audio: np.ndarray, silence_threshold_db: float = -60.0) -> np.ndarray:
    """Trim trailing silence using 10 ms RMS windows (host-side)."""
    window = int(0.01 * SAMPLE_RATE)
    if len(audio) < window:
        return audio
    thresh = 10.0 ** (silence_threshold_db / 20.0)
    n_win = len(audio) // window
    rms = np.sqrt(np.mean(np.square(audio[: n_win * window].reshape(n_win, window)), axis=1))
    loud = np.flatnonzero(rms >= thresh)
    trailing = n_win if loud.size == 0 else n_win - 1 - int(loud[-1])
    if trailing == 0:
        return audio
    return audio[: -trailing * window]


def align_prior(mu_x, durations, y_fine_lengths, y_fine_len: int):
    """Stage B's prelude: the encoder's prior expanded by the durations to
    ``y_fine_len`` fine frames, then halved to the decoder's frames →
    (mu_y (B, T, C) fp32, y_mask (B, T))."""
    y_fine_mask = sequence_mask(y_fine_lengths, y_fine_len).to(torch.float32)
    # prior assembly as an fp32 gather: searchsorted over the duration
    # cumsum (right side skips zero-duration tokens, like generate_path)
    cum = torch.cumsum(durations.to(torch.int32), dim=1)
    frames = torch.arange(y_fine_len, dtype=torch.int32, device=mu_x.device)
    idx = torch.searchsorted(cum, frames[None].expand(cum.shape[0], -1).contiguous(), right=True)
    # frames at/after the total duration are zero, as in the dense path
    in_range = (frames[None, :] < cum[:, -1:]).to(torch.float32)
    idx = torch.clamp(idx, 0, mu_x.shape[1] - 1)
    mu_y_fine = torch.gather(
        mu_x.float(), 1, idx[..., None].expand(-1, -1, mu_x.shape[-1])
    ) * (y_fine_mask * in_range)[..., None]
    mu_y = downsample_time(mu_y_fine)
    y_lengths = (y_fine_lengths + 1) // 2
    return mu_y, sequence_mask(y_lengths, mu_y.shape[1]).to(torch.float32)


def _as_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v) for k, v in params.items()}


class _Replica:
    """One device's model, vocoder and noise row, and the stages that run
    on them; in a fan-out also the replica's host thread and CUDA stream."""

    def __init__(self, cfg: MatchaConfig, device: torch.device, params, vocos_cfg: VocosConfig,
                 vocos_params, noise_row: torch.Tensor, fan_out: bool):
        strict_fp32(device)
        self.cfg, self.device = cfg, device
        self.model = MatchaTTS(cfg)
        self.model.load_state_dict(params)
        self.model.to(device).eval()
        self.vocos = None
        if vocos_params is not None:
            self.vocos = Vocos(vocos_cfg)
            self.vocos.load_state_dict(vocos_params)
            self.vocos.to(device).eval()
        self.noise_row = noise_row.to(device)
        self.thread = ThreadPoolExecutor(1, thread_name_prefix="synth-replica") if fan_out else None
        self.stream = torch.cuda.Stream(device) if fan_out and device.type == "cuda" else None
        if self.stream is not None:
            torch.cuda.synchronize(device)  # the weights are in place before another stream reads them

    def run(self, fn, *args):
        """``fn(self, *args)`` on this replica's CUDA stream, if it has one."""
        with torch.cuda.stream(self.stream) if self.stream is not None else nullcontext():
            return fn(self, *args)

    # -- stage A ------------------------------------------------------------

    @torch.inference_mode()
    def encode(self, x, x_lengths, spk_enc, spk_dur, scale):
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(torch.float32)
        mu_x, durations = self.model.encode(x, x_mask, spk_enc, spk_dur)
        # per-speaker correction x user pace, then round-to-nearest with a
        # floor of 1 frame (reference: inference.py:130-143)
        durations = torch.clamp(torch.round(durations * scale), min=1.0) * x_mask
        return mu_x, durations, x_mask

    # -- stage B ------------------------------------------------------------

    def noise(self, b: int, t: int) -> torch.Tensor:
        if t > self.noise_row.shape[0]:
            raise ValueError(f"{t} frames exceed the noise row ({self.noise_row.shape[0]})")
        return self.noise_row[:t][None].expand(b, t, self.noise_row.shape[1])

    @torch.inference_mode()
    def decode(self, mu_x, durations, x_mask, y_fine_lengths, noise=None, *,
                y_fine_len: int, n_timesteps: int, solver: str):
        mu_y, y_mask = align_prior(mu_x, durations, y_fine_lengths, y_fine_len)
        if noise is None:
            noise = self.noise(mu_y.shape[0], mu_y.shape[1])

        dec = self.model.decode(mu_y, y_mask, n_timesteps, solver, noise=noise)
        stats = self.cfg.data_statistics
        ym = y_mask[..., None]
        mel = denormalize(dec, stats.mel_mean, stats.mel_std)
        mel = mel * ym + (1.0 - ym) * stats.mel_mean
        enc_mel = denormalize(mu_y, stats.mel_mean, stats.mel_std) * ym + (1.0 - ym) * stats.mel_mean
        if self.vocos is None:
            return mel, None, enc_mel
        wav = self.vocos(mel)
        # peak-normalize to 0.95 only when clipping (reference: inference.py:260-265)
        peak = wav.abs().amax(dim=-1, keepdim=True)
        wav = torch.where(peak > 1.0, wav / peak * 0.95, wav)
        return mel, wav, enc_mel

    # -- fused path ---------------------------------------------------------

    @torch.inference_mode()
    def synth_fused(self, x, x_lengths, spk_enc, spk_dur, scale, noise=None, *,
                     y_fine_len: int, n_timesteps: int, solver: str):
        """Both stages at a mel bucket fixed up-front; returns the true total
        duration so the host can detect overflow and fall back."""
        mu_x, durations, x_mask = self.encode(x, x_lengths, spk_enc, spk_dur, scale)
        total = durations.sum(dim=1).to(torch.int32)
        y_fine_lengths = torch.clamp(total, 2, y_fine_len)
        mel, wav, _ = self.decode(mu_x, durations, x_mask, y_fine_lengths, noise,
                                   y_fine_len=y_fine_len, n_timesteps=n_timesteps,
                                   solver=solver)
        return mel, wav, total


class MatchaSynthesizer:
    """Holds the model and vocoder on one device (or a replica on each
    device of ``mesh``) and exposes synthesise().

    ``params`` / ``vocos_params``: state_dicts in the port's (reference
    torch) layout — ``weights.params_from_jax`` bridges a JAX tree,
    ``models.matcha.init_params`` draws random ones.  ``vocos_params=None``
    returns mels only.  ``mesh``: a list of devices (repeats allowed) to
    fan batches out over; ``device`` is then ignored.
    """

    # fine frames a voiced token tends to expand to at pace 1.0 (a corpus
    # statistic of the trained model; FUSED_FRAMES_PER_TOKEN in serving)
    fused_frames_per_token: float = 8.0

    def __init__(
        self,
        cfg: MatchaConfig,
        params: Mapping,
        vocos_params: Mapping | None = None,
        vocos_cfg: VocosConfig = VocosConfig(),
        text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
        mel_fine_buckets: Sequence[int] = DEFAULT_MEL_FINE_BUCKETS,
        device: str | torch.device | None = None,
        mesh: Sequence[str | torch.device] | None = None,
    ):
        if mesh is not None and not len(mesh):
            raise ValueError("mesh needs at least one device")
        devices = [resolve_device(d) for d in mesh] if mesh is not None else [resolve_device(device)]
        self.mesh = devices if mesh is not None else None
        self.n_dev = len(devices)
        self.cfg = cfg
        params = _as_state_dict(params)
        # speaker-mixing blends run in host numpy
        self._spk_tables_np = (
            params["speaker_embeddings_enc.weight"].float().numpy(),
            params["speaker_embeddings_dur.weight"].float().numpy(),
        )
        self.vocos_cfg = vocos_cfg
        self.vocos_params = vocos_params
        if vocos_params is not None:
            vocos_params = _as_state_dict(vocos_params)
        max_tx = cfg.encoder.rope_max_len
        kept = tuple(b for b in text_buckets if b <= max_tx)
        self.text_buckets = kept or (max_tx,)
        self.mel_fine_buckets = tuple(fix_len_compatibility(b // 2) * 2 for b in mel_fine_buckets)
        # the ODE's initial-noise row (the JAX package's seeded draw), made
        # once at the largest coarse bucket; a bucket of T coarse frames
        # uses its first T rows
        noise_row = seeded_synthesis_noise((self.mel_fine_buckets[-1] + 1) // 2, cfg.n_feats)
        self.replicas = [_Replica(cfg, dev, params, vocos_cfg, vocos_params, noise_row, mesh is not None)
                         for dev in devices]

    # the first (without a mesh, the only) replica's device, model and vocoder
    @property
    def device(self) -> torch.device:
        return self.replicas[0].device

    @property
    def model(self) -> MatchaTTS:
        return self.replicas[0].model

    @property
    def vocos(self) -> Vocos | None:
        return self.replicas[0].vocos

    def predict_fine_bucket(self, tx: int, scale: float = 1.0) -> int:
        """Mel bucket guess for the fused path: ``fused_frames_per_token``
        fine frames per token (≈ 2 ids) at pace 1.0, times the request's
        duration scale, clamped to the ladder."""
        expect = int((tx // 2) * self.fused_frames_per_token * max(scale, 0.0))
        expect = min(max(expect, 1), self.mel_fine_buckets[-1])
        return pick_bucket(expect, self.mel_fine_buckets)

    def fused_warm_buckets(self, tx: int) -> list[int]:
        """Every mel bucket predict_fine_bucket can return for ``tx`` across
        the serving pace range."""
        lo = self.predict_fine_bucket(tx, MIN_LENGTH_SCALE)
        hi = self.predict_fine_bucket(tx, MAX_LENGTH_SCALE * MAX_SCALE_CORRECTION)
        return [b for b in self.mel_fine_buckets if lo <= b <= hi]

    # -- public -------------------------------------------------------------

    def speaker_embedding(self, voice_mix: Sequence[tuple[int, float]]):
        """Weighted blend of speaker-embedding rows (host numpy) → two (1, D)
        tensors on the device."""
        e, d = self._speaker_embedding_np(voice_mix)
        return (torch.from_numpy(e[None]).to(self.device),
                torch.from_numpy(d[None]).to(self.device))

    def _speaker_embedding_np(self, voice_mix):
        enc_tab, dur_tab = self._spk_tables_np
        enc = sum(w * enc_tab[i] for i, w in voice_mix)
        dur = sum(w * dur_tab[i] for i, w in voice_mix)
        return np.asarray(enc, np.float32), np.asarray(dur, np.float32)

    @torch.inference_mode()
    def vocode(self, mel):
        """Denormalized log-mel (B, T, n_mels) → waveform tensor on the device."""
        return self.vocos(torch.as_tensor(mel, dtype=torch.float32, device=self.device))

    def _stage_a_inputs(self, id_lists, voice_mixes, scales, b_pad, tx):
        """Stage A's inputs for ``b_pad`` rows as CPU tensors; pad rows
        carry one token, the first mix's speaker and scale 1."""
        x = np.zeros((b_pad, tx), np.int64)
        for k, ids in enumerate(id_lists):
            x[k, : len(ids)] = ids
        lengths = [len(ids) for ids in id_lists] + [1] * (b_pad - len(id_lists))
        enc_rows, dur_rows = zip(*(self._speaker_embedding_np(m) for m in voice_mixes))
        enc_rows = list(enc_rows) + [enc_rows[0]] * (b_pad - len(id_lists))
        dur_rows = list(dur_rows) + [dur_rows[0]] * (b_pad - len(id_lists))
        scales = list(scales) + [1.0] * (b_pad - len(id_lists))
        return (
            torch.from_numpy(x),
            torch.tensor(lengths, dtype=torch.int64),
            torch.from_numpy(np.stack(enc_rows)),
            torch.from_numpy(np.stack(dur_rows)),
            torch.tensor(scales, dtype=torch.float32)[:, None],
        )

    # -- fan-out ------------------------------------------------------------

    def _pad_batch(self, b: int) -> int:
        """Rows a group of ``b`` pads to: the power-of-2 ladder, then a
        multiple of the device count."""
        b_pad = 1 << (b - 1).bit_length() if b > 1 else 1
        return -(-b_pad // self.n_dev) * self.n_dev

    def _fan_out(self, fn, per_replica: Sequence[tuple]) -> list:
        """``fn(replica, *args)`` for each replica's args, in replica order.
        Without a mesh, inline; with one, each replica on its own host
        thread and CUDA stream."""
        if self.mesh is None:
            return [fn(self.replicas[0], *per_replica[0])]
        futures = [rep.thread.submit(rep.run, fn, *args) for rep, args in zip(self.replicas, per_replica)]
        return [f.result() for f in futures]

    def _row_blocks(self, *tensors) -> list[tuple]:
        """Host tensors → each replica's contiguous block of rows."""
        if self.n_dev == 1:
            return [tensors]
        per = tensors[0].shape[0] // self.n_dev
        return [tuple(t[k * per:(k + 1) * per] for t in tensors) for k in range(self.n_dev)]

    def _run_fused(self, host_args, **kw):
        """The fused program over a padded batch → gathered (totals, wav
        or None) on the host, one copy per replica."""
        def rows(rep, *block):
            _, wav, total = rep.synth_fused(*(t.to(rep.device) for t in block), **kw)
            return _to_host(total, *([wav] if wav is not None else []))

        parts = self._fan_out(rows, self._row_blocks(*host_args))
        wav = None if len(parts[0]) == 1 else _gather([p[1] for p in parts])
        return _gather([p[0] for p in parts]), wav

    def _run_encode(self, host_args):
        """Stage A over a padded batch → (each replica's device outputs,
        gathered durations)."""
        def rows(rep, *block):
            out = rep.encode(*(t.to(rep.device) for t in block))
            return out, _to_host(out[1])[0]

        parts = self._fan_out(rows, self._row_blocks(*host_args))
        return [p[0] for p in parts], _gather([p[1] for p in parts])

    def _run_decode(self, encs, y_fine_lengths: np.ndarray, pull_mel: bool = False, **kw):
        """Stage B over a padded batch → gathered (mel or None, wav or
        None), and the first replica's enc_mel."""
        def rows(rep, enc, lengths):
            mel, wav, enc_mel = rep.decode(*enc, lengths.to(rep.device), **kw)
            pulled = _to_host(*([mel] if pull_mel else []), *([wav] if wav is not None else []))
            return (pulled[0] if pull_mel else None), (pulled[-1] if wav is not None else None), enc_mel

        lengths = self._row_blocks(torch.as_tensor(y_fine_lengths, dtype=torch.int64))
        parts = self._fan_out(rows, [(enc, yl) for enc, (yl,) in zip(encs, lengths)])
        mel = _gather([p[0] for p in parts]) if pull_mel else None
        wav = None if parts[0][1] is None else _gather([p[1] for p in parts])
        return mel, wav, parts[0][2]

    # -- public, continued ----------------------------------------------------

    def synthesise_ids(
        self,
        phoneme_ids: Sequence[int],
        speaker: int = 0,
        voice_mix: Sequence[tuple[int, float]] | None = None,
        n_timesteps: int = DEFAULT_NUM_STEPS,
        solver: str = DEFAULT_ODE_SOLVER,
        length_scale: float = 1.0,
        scale_correction: float | None = None,
        debug: bool = False,
        fused: bool = False,
    ) -> SynthesisResult:
        t0 = time.perf_counter()
        if voice_mix is None:
            voice_mix = [(speaker, 1.0)]
        if scale_correction is None:
            scale_correction = blended_scale_correction(voice_mix)
        n = len(phoneme_ids)
        tx = pick_bucket(n, self.text_buckets)
        scale = scale_correction * length_scale
        # under a fan-out a single request pads to one row per device; the
        # pad rows carry one token
        b_pad = self.n_dev
        args = self._stage_a_inputs([phoneme_ids], [voice_mix], [scale], b_pad, tx)
        kw = dict(n_timesteps=n_timesteps, solver=solver)

        if fused and not debug:
            y_fine_len = self.predict_fine_bucket(tx, scale)
            totals, wav_full = self._run_fused(args, y_fine_len=y_fine_len, **kw)
            total_fine = int(totals[0])
            if total_fine <= y_fine_len:
                n_frames = (max(total_fine, 2) + 1) // 2
                wav_np = np.zeros((0,), np.float32)
                if wav_full is not None:
                    n_samples = max((n_frames - 1) * STD_RES_HOP_LENGTH, 0)
                    wav_np = trim_trailing_silence(wav_full[0, :n_samples])
                return self._result(wav_np, n_frames, t0)
            # rare overflow (speech longer than the text-predicted bucket):
            # fall through to the exact two-stage path below

        encs, durations_np = self._run_encode(args)
        total_fine = int(durations_np.sum(axis=1)[0])
        # floor of 2 frames; runaway predictions clamp to the largest bucket
        total_fine = min(max(total_fine, 2), self.mel_fine_buckets[-1])
        y_fine_len = pick_bucket(total_fine, self.mel_fine_buckets)
        mel, wav_full, enc_mel = self._run_decode(
            encs, np.asarray([total_fine] + [2] * (b_pad - 1)), pull_mel=debug,
            y_fine_len=y_fine_len, **kw,
        )
        n_frames = (total_fine + 1) // 2
        wav_np = np.zeros((0,), np.float32)
        if wav_full is not None:
            n_samples = max((n_frames - 1) * STD_RES_HOP_LENGTH, 0)
            wav_np = trim_trailing_silence(wav_full[0, :n_samples])
        result = self._result(wav_np, n_frames, t0)
        if debug:
            result.mel = mel[0, :n_frames]
            result.durations = durations_np[0, :n]
            if self.vocos is not None:
                enc_wav = self.vocode(enc_mel[:1, :n_frames])
                result.encoder_wav = enc_wav[0].cpu().numpy()
        return result

    @staticmethod
    def _result(wav_np: np.ndarray, n_frames: int, t0: float) -> SynthesisResult:
        elapsed = time.perf_counter() - t0
        audio_sec = len(wav_np) / SAMPLE_RATE if len(wav_np) else n_frames * STD_RES_HOP_LENGTH / SAMPLE_RATE
        return SynthesisResult(wav=wav_np, rtf=elapsed / max(audio_sec, 1e-9), latency_s=elapsed)

    def synthesise_batch(
        self,
        id_lists: Sequence[Sequence[int]],
        speakers: Sequence[int] | None = None,
        n_timesteps: int = DEFAULT_NUM_STEPS,
        solver: str = DEFAULT_ODE_SOLVER,
        length_scales: Sequence[float] | None = None,
        voice_mixes: Sequence[Sequence[tuple[int, float]]] | None = None,
        fused: bool = False,
    ) -> list[SynthesisResult]:
        """Batched synthesis: utterances padded to common text/mel buckets
        and decoded in one call; the batch pads to a power of two, then to
        a device multiple."""
        t0 = time.perf_counter()
        b = len(id_lists)
        if voice_mixes is None:
            if speakers is None or len(speakers) != b:
                raise ValueError("pass one speaker or voice mix per utterance")
            voice_mixes = [[(spk, 1.0)] for spk in speakers]
        if len(voice_mixes) != b:
            raise ValueError("pass one voice mix per utterance")
        length_scales = length_scales or [1.0] * b
        b_pad = self._pad_batch(b)
        tx = pick_bucket(max(len(ids) for ids in id_lists), self.text_buckets)
        scales = [blended_scale_correction(m) * s for m, s in zip(voice_mixes, length_scales)]
        args = self._stage_a_inputs(id_lists, voice_mixes, scales, b_pad, tx)
        kw = dict(n_timesteps=n_timesteps, solver=solver)

        if fused:
            # the group shares ONE mel bucket, sized for its slowest pace
            yf_pred = self.predict_fine_bucket(tx, max(scales))
            totals, wav_np = self._run_fused(args, y_fine_len=yf_pred, **kw)
            totals = totals.astype(int)
            if int(totals[:b].max(initial=2)) <= yf_pred:
                return self._collect_batch_results(b, wav_np, np.clip(totals, 2, yf_pred), t0)
            # overflow in at least one utterance: exact two-stage path

        encs, durations_np = self._run_encode(args)
        totals = np.clip(durations_np.sum(axis=1).astype(int), 2, self.mel_fine_buckets[-1])
        y_fine_len = pick_bucket(int(totals.max()), self.mel_fine_buckets)
        _, wav_np, _ = self._run_decode(encs, totals, y_fine_len=y_fine_len, **kw)
        return self._collect_batch_results(b, wav_np, totals, t0)

    def _collect_batch_results(self, b: int, wav_np, totals, t0: float) -> list[SynthesisResult]:
        elapsed = time.perf_counter() - t0
        wavs = []
        for k in range(b):
            frames = (int(totals[k]) + 1) // 2
            if wav_np is not None:
                n_samples = max((frames - 1) * STD_RES_HOP_LENGTH, 0)
                wavs.append(trim_trailing_silence(wav_np[k, :n_samples]))
            else:
                wavs.append(np.zeros((0,), np.float32))
        # throughput RTF: the call produced sum(audio) in `elapsed`; each
        # request's latency is the whole call's wall time
        total_audio = max(sum(len(w) for w in wavs) / SAMPLE_RATE, 1e-9)
        return [SynthesisResult(wav=w, rtf=elapsed / total_audio, latency_s=elapsed) for w in wavs]

    def synthesise(self, text: str, speaker: int = 0,
                   voice_mix: Sequence[tuple[int, float]] | None = None, **kwargs) -> SynthesisResult:
        """Raw-text entry point; requires the eSpeak host frontend."""
        from matcha_tpu_torch.text.phonemizers import (
            emphasize_intonation_marks,
            multilingual_phonemizer,
        )

        primary = voice_mix[0][0] if voice_mix else speaker
        language = voice_by_id(primary)["lang"]
        _, ids = multilingual_phonemizer(emphasize_intonation_marks(text), language)
        return self.synthesise_ids(ids, speaker=speaker, voice_mix=voice_mix, **kwargs)

    def reachable_bucket_pairs(self) -> list[tuple[int, int]]:
        """Every (text_bucket, mel_fine_bucket) pair a request can hit."""
        pairs = []
        for i, tx in enumerate(self.text_buckets):
            prev_tx = self.text_buckets[i - 1] if i else 0
            pairs.extend((tx, yf) for yf in self.mel_fine_buckets if yf > prev_tx)
        return pairs

    def _warm_pair(self, tx: int, y_fine_len: int, n_timesteps: int, solver: str, b: int = 1):
        """Run stage A at ``tx`` and stage B at (tx, y_fine_len), batch ``b``,
        on synthetic inputs."""
        n = max(tx // 2, 2)
        args = self._stage_a_inputs([[0] * n] * b, [[(0, 1.0)]] * b, [1.0] * b, b, tx)
        encs, _ = self._run_encode(args)
        self._run_decode(encs, np.full((b,), min(n, y_fine_len)), y_fine_len=y_fine_len,
                         n_timesteps=n_timesteps, solver=solver)

    def warmup(
        self,
        n_timesteps: int = DEFAULT_NUM_STEPS,
        solver: str = DEFAULT_ODE_SOLVER,
        full: bool = False,
        batch_sizes: Sequence[int] = (1,),
        fused: bool = False,
        on_size_ready=None,
    ):
        """Run the serving shapes once before traffic arrives.

        Nothing compiles per shape here, as it does under jit; the first
        run builds the CUDA kernels and sets up cuBLAS/cuDNN and the
        allocator.  The default runs the smallest text bucket at its most
        likely mel bucket for each batch size; ``full=True`` runs every
        reachable (text, mel) pair.  ``fused`` is accepted for the JAX
        package's signature: the fused path runs the same modules.
        ``on_size_ready(b)`` is called after each batch size.  Under a
        fan-out the sizes round up to device multiples, as the serving
        paths pad them.
        """
        del fused
        batch_sizes = sorted({-(-b // self.n_dev) * self.n_dev for b in batch_sizes})
        tx0 = self.text_buckets[0]
        expect = min(int((tx0 // 2) * self.fused_frames_per_token), self.mel_fine_buckets[-1])
        pairs = self.reachable_bucket_pairs() if full else [(tx0, pick_bucket(expect, self.mel_fine_buckets))]
        for b in batch_sizes:
            for tx, yf in pairs:
                self._warm_pair(tx, yf, n_timesteps, solver, b=b)
            if on_size_ready is not None:
                on_size_ready(b)
