"""Port parity: the log-mel frontend against ``matcha_tpu.audio.mel``.

Same waveforms (a real 24 kHz recording from ``mcd_validation/`` and a
seeded noise burst) through the JAX functions and the port's, on the CPU.
Tolerances: the Hann window and both filterbanks 1e-6 (the same float64
numpy formulas, cast to float32); log-mel, coarse and fine, HTK and slaney,
and the legacy HiFiGAN mel, max |Δ| 2e-3 (fp32 FFTs of different
libraries; the floor of the log amplifies tiny magnitudes the most).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.audio import mel as jax_mel
from matcha_tpu.utils.audio_io import read_wav
from matcha_tpu_torch.audio import mel as port_mel

FIXTURE = Path(__file__).resolve().parent.parent / "mcd_validation" / "original_speaker_000.wav"
LOG_MEL_TOL = 2e-3


def _waves():
    real, sr = read_wav(FIXTURE)
    assert sr == 24000
    noise = (np.random.default_rng(0).standard_normal(24000 + 77) * 0.1).astype(np.float32)
    return {"recording": real, "noise": noise}


WAVES = _waves()


def _port_cfg(cfg):
    return port_mel.MelConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


@pytest.mark.parametrize("n", [1024, 512, 1000])
def test_hann_window(n):
    np.testing.assert_allclose(port_mel.hann_window(n), jax_mel.hann_window(n), rtol=0, atol=1e-6)


@pytest.mark.parametrize("args", [(24000, 1024, 100, 0.0, 12000.0, "htk"),
                                  (24000, 1024, 100, 0.0, 12000.0, "slaney"),
                                  (22050, 1024, 80, 0.0, 8000.0, "slaney")])
def test_filterbank(args):
    got, want = port_mel.mel_filterbank(*args), jax_mel.mel_filterbank(*args)
    assert got.shape == want.shape == (args[1] // 2 + 1, args[2])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("wave", sorted(WAVES))
@pytest.mark.parametrize("scale", ["htk", "slaney"])
@pytest.mark.parametrize("fine", [False, True], ids=["coarse", "fine"])
def test_log_mel(wave, scale, fine):
    wav = WAVES[wave]
    cfg = jax_mel.MelConfig(mel_scale=scale)
    cfg = cfg.fine if fine else cfg
    want = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wav), cfg))
    got = port_mel.log_mel_spectrogram(torch.from_numpy(wav), _port_cfg(cfg))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (1 + len(wav) // cfg.hop_length, cfg.n_mels)
    assert np.abs(got.numpy() - want).max() <= LOG_MEL_TOL


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_legacy_hifigan_mel(wave):
    wav = WAVES[wave]
    want = np.asarray(jax_mel.legacy_hifigan_mel(jnp.asarray(wav)))
    got = port_mel.legacy_hifigan_mel(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOG_MEL_TOL


def test_batched_input_matches_rows():
    wav = np.stack([WAVES["noise"][:9000], WAVES["recording"][:9000]])
    cfg = port_mel.MelConfig()
    batched = port_mel.log_mel_spectrogram(torch.from_numpy(wav), cfg)
    assert batched.shape == (2, 1 + 9000 // 256, 100)
    for i in range(2):
        row = port_mel.log_mel_spectrogram(torch.from_numpy(wav[i]), cfg)
        torch.testing.assert_close(batched[i], row, rtol=0, atol=1e-5)
    want = np.asarray(jax_mel.legacy_hifigan_mel(jnp.asarray(wav)))
    assert np.abs(port_mel.legacy_hifigan_mel(torch.from_numpy(wav)).numpy() - want).max() <= LOG_MEL_TOL
