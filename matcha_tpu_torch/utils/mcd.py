"""Mel-cepstral distortion (MCD) with DTW alignment.

The port's own copy of ``matcha_tpu/utils/mcd.py``: numpy/scipy on the
host, except the ``mel`` basis's log-mel, which the port's extractor
computes on ``device`` (the card unless the caller passes "cpu").

The reference delegates MCD to the ``pymcd`` package (WORLD/SPTK cepstra;
reference: matcha/utils/mcd_validate.py, matcha/utils/compute_mcd.py), and
its quality bands (<4 dB production grade, reference mcd_validate.py:7-9)
are pymcd numbers.  Three bases are offered here:

  * ``pymcd``  — the reference's own toolbox, used verbatim when the
    package is installed (production eval images): numbers directly
    comparable to the 3.80–4.06 dB baselines.
  * ``sptk``   — self-contained reimplementation of pymcd's pipeline
    (22.05 kHz, 5 ms frames, 512-FFT power envelope, α=0.65 mel-warped
    cepstra via the freqt recursion, order 13, c0 excluded, same
    (10/ln10)·√2 constant, exact DTW).  Same *family* as pymcd; the
    envelope differs (STFT periodogram vs WORLD CheapTrick), so absolute
    values sit near but not exactly on pymcd's.
  * ``mel``    — the framework's own log-mel→DCT cepstra with silence
    gating: the most sensitive basis for regression-gating this model's
    own runs (it shares the training mel front-end).

``basis="auto"`` (the CLI default) picks pymcd when available, else sptk.
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from matcha_tpu_torch.inference import resolve_device

MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


DYNAMIC_RANGE_NAT = 11.5  # ≈ 50 dB utterance-relative spectral floor
ENERGY_GATE_NAT = 6.9     # ≈ 30 dB below the loudest frame → dropped


def mel_cepstra(wav: np.ndarray, cfg: MelConfig | None = None, n_coeffs: int = 13,
                device=None) -> np.ndarray:
    """(T,) waveform → (frames, n_coeffs) cepstra (c_1..c_n, c_0 dropped).

    Two robustness measures mirror what WORLD/SPTK-based MCD (pymcd, the
    reference's metric) does implicitly:
      * the linear-mel floor is utterance-relative (max − ~50 dB), not the
        absolute 1e-7 training floor — otherwise near-silent frames compare
        log(1e-7) against log(noise) and dominate the distance;
      * frames more than ~30 dB below the loudest frame (pauses, trailing
        room tone) are excluded — cepstra of silence carry no speech detail.
    """
    from scipy.fft import dct

    cfg = cfg or MelConfig()
    w = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(resolve_device(device))
    mel = log_mel_spectrogram(w, cfg).cpu().numpy()  # (T, C), ln
    floor = mel.max() - DYNAMIC_RANGE_NAT
    mel = np.maximum(mel, floor)
    frame_energy = mel.mean(axis=1)
    keep = frame_energy > frame_energy.max() - ENERGY_GATE_NAT
    ceps = dct(mel[keep], type=2, axis=-1, norm="ortho")
    return ceps[:, 1 : n_coeffs + 1]


# ---------------------------------------------------------------------------
# SPTK-family basis (pymcd's pipeline, self-contained)
# ---------------------------------------------------------------------------

SPTK_SR = 22050          # pymcd resamples everything to 22.05 kHz
SPTK_FRAME_MS = 5.0      # pymcd FRAME_PERIOD
SPTK_FFT = 512           # pymcd fft_size
SPTK_ALPHA = 0.65        # all-pass warping factor (≈ mel scale at 22 kHz)
SPTK_ORDER = 13          # mcep order; c1..c13 enter the distance


def _resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wav
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    return resample_poly(wav.astype(np.float64), frac.numerator, frac.denominator)


def _freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """SPTK's frequency transform: plain→mel-warped cepstrum (vectorized
    over frames).  c: (frames, n_in) → (frames, order+1)."""
    frames, n_in = c.shape
    out = np.zeros((frames, order + 1))
    for i in range(n_in - 1, -1, -1):
        prev = out.copy()
        out[:, 0] = c[:, i] + alpha * prev[:, 0]
        if order >= 1:
            out[:, 1] = (1.0 - alpha * alpha) * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order + 1):
            out[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - out[:, m - 1])
    return out


def sptk_mel_cepstra(wav: np.ndarray, sr: int = 24000) -> np.ndarray:
    """(T,) waveform → (frames, SPTK_ORDER) warped cepstra c1..c13.

    pymcd's pipeline with one documented substitution: the spectral
    envelope is an STFT periodogram (hann 512) instead of WORLD CheapTrick
    (whose F0-adaptive smoothing needs the WORLD C library).  Frame period,
    sample rate, FFT size, warping α, order, and the c0 exclusion match.
    """
    w = _resample(np.asarray(wav, np.float64), sr, SPTK_SR)
    hop = int(SPTK_SR * SPTK_FRAME_MS / 1000.0)  # 110 samples
    win = np.hanning(SPTK_FFT)
    n_frames = max(1 + (len(w) - SPTK_FFT) // hop, 0)
    if n_frames == 0:
        return np.zeros((0, SPTK_ORDER))
    idx = np.arange(SPTK_FFT)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = w[idx] * win[None, :]
    power = np.abs(np.fft.rfft(frames, n=SPTK_FFT, axis=1)) ** 2
    log_amp = 0.5 * np.log(np.maximum(power, 1e-20))
    # real cepstrum → minimum-phase fold (c0 kept, k>0 doubled) → warp
    r = np.fft.irfft(log_amp, n=SPTK_FFT, axis=1)[:, : SPTK_FFT // 2 + 1]
    r[:, 1:] *= 2.0
    mc = _freqt(r, SPTK_ORDER, SPTK_ALPHA)
    return mc[:, 1:]  # drop c0 (gain)


def dtw_path_cost(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-step Euclidean distance along the optimal DTW path."""
    na, nb = len(a), len(b)
    dist = np.sqrt(
        np.maximum(
            np.sum(a * a, axis=1)[:, None]
            + np.sum(b * b, axis=1)[None, :]
            - 2.0 * (a @ b.T),
            0.0,
        )
    )
    acc = np.full((na + 1, nb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, na + 1):
        row_prev = acc[i - 1]
        row = acc[i]
        d = dist[i - 1]
        for j in range(1, nb + 1):
            row[j] = d[j - 1] + min(row_prev[j], row[j - 1], row_prev[j - 1])
    # path length: backtrack count
    i, j, steps = na, nb, 0
    while i > 1 or j > 1:
        steps += 1
        choices = (
            (acc[i - 1, j - 1], i - 1, j - 1),
            (acc[i - 1, j], i - 1, j),
            (acc[i, j - 1], i, j - 1),
        )
        _, i, j = min(choices, key=lambda c: c[0])
    return float(acc[na, nb] / max(steps + 1, 1))


def pymcd_available() -> bool:
    try:
        import pymcd  # noqa: F401

        return True
    except ImportError:
        return False


def _mcd_via_pymcd(wav_ref: np.ndarray, wav_syn: np.ndarray, sr: int) -> float:
    """Exact reference metric via the pymcd toolbox (when installed)."""
    import tempfile
    import wave as wave_mod
    from pathlib import Path

    from pymcd.mcd import Calculate_MCD

    def _write(path: Path, wav: np.ndarray):
        pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave_mod.open(str(path), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(pcm.tobytes())

    with tempfile.TemporaryDirectory() as d:
        rp, sp = Path(d) / "ref.wav", Path(d) / "syn.wav"
        _write(rp, wav_ref)
        _write(sp, wav_syn)
        return float(Calculate_MCD(MCD_mode="dtw").calculate_mcd(str(rp), str(sp)))


def mcd_dtw(
    wav_ref: np.ndarray,
    wav_syn: np.ndarray,
    cfg: MelConfig | None = None,
    trim_silence_db: float | None = None,
    basis: str = "mel",
    sample_rate: int = 24000,
    device=None,
) -> float:
    """MCD (dB) between a reference and a synthesized waveform.

    ``basis``: "mel" (framework cepstra + silence gate, best for
    regression-gating own runs), "sptk" (pymcd's pipeline re-implemented —
    near-comparable to the reference's published bands), "pymcd" (the
    reference toolbox itself, exact numbers), or "auto" (pymcd if
    installed, else sptk).

    Edge trimming is off by default: the utterance-relative energy gate in
    ``mel_cepstra`` already drops silence, and an absolute-dB trim would
    break the metric's gain invariance (c_0 is excluded, so MCD must not
    change under amplitude scaling).  ``device`` is where the ``mel``
    basis's log-mel runs.
    """
    if basis == "auto":
        basis = "pymcd" if pymcd_available() else "sptk"
    if trim_silence_db is not None:
        wav_ref = _trim_edges(wav_ref, trim_silence_db)
        wav_syn = _trim_edges(wav_syn, trim_silence_db)
    if basis == "pymcd":
        return _mcd_via_pymcd(wav_ref, wav_syn, sample_rate)
    if basis == "sptk":
        ca = sptk_mel_cepstra(wav_ref, sample_rate)
        cb = sptk_mel_cepstra(wav_syn, sample_rate)
    else:
        ca = mel_cepstra(wav_ref, cfg, device=device)
        cb = mel_cepstra(wav_syn, cfg, device=device)
    if len(ca) == 0 or len(cb) == 0:
        return float("nan")
    return MCD_CONST * dtw_path_cost(ca, cb)


SILENCE_WINDOW_MS = 10.0


def _trim_edges(wav: np.ndarray, threshold_db: float) -> np.ndarray:
    """Drop the leading and trailing 10 ms RMS windows below ``threshold_db``
    (the JAX package's ``utils/silence.py::silence_bounds``)."""
    sr = 24000
    win = int(SILENCE_WINDOW_MS / 1000.0 * sr)
    n = len(wav) // win
    rms = np.sqrt(np.mean(np.square(wav[: n * win].reshape(n, win)), axis=1))
    loud = np.flatnonzero(rms >= 10.0 ** (threshold_db / 20.0))
    if loud.size == 0:  # all silent: counted as leading
        lead, trail = n, 0
    else:
        lead, trail = int(loud[0]), n - 1 - int(loud[-1])
    return wav[lead * win : len(wav) - trail * win]
