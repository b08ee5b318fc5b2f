"""Port parity: MCD (``utils/mcd.py``), ``compute_mcd`` and the vocoder
self-test against the JAX package, on the ``mcd_validation/`` recordings.

Tolerances: ``mcd_dtw`` within 1e-4 dB on the ``sptk``, ``mel`` and
``auto`` bases (``pymcd`` is the external toolbox, not ported code; without
it ``auto`` is ``sptk``); the SPTK cepstra and ``_freqt`` exactly equal
(the same numpy code); the mel cepstra 2e-3 (the log-mel tolerance of
``tests/test_torch_mel.py``).  The CLIs print two decimals: their scores
agree within 0.006 dB (rounding plus 1e-3).
"""

import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu.utils import compute_mcd as jax_compute_mcd
from matcha_tpu.utils import mcd as jax_mcd
from matcha_tpu.utils.audio_io import read_wav, write_wav
from matcha_tpu.vocoder import selftest as jax_selftest
from matcha_tpu_torch.utils import compute_mcd
from matcha_tpu_torch.utils import mcd as port_mcd
from matcha_tpu_torch.vocoder import selftest
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params
from matcha_tpu_torch.weights import vocos_params_to_jax

FIXTURES = Path(__file__).resolve().parent.parent / "mcd_validation"
SR = 24000


def clip(i, n=int(1.5 * SR)):
    wav, sr = read_wav(FIXTURES / f"original_speaker_00{i}.wav")
    assert sr == SR
    return wav[:n]


def pairs():
    rng = np.random.default_rng(0)
    a = clip(2)
    noisy = (0.7 * a + 0.01 * rng.standard_normal(len(a))).astype(np.float32)
    return {"other_speaker": (clip(0), clip(1)), "same_noisy": (a, noisy)}


PAIRS = pairs()


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("basis", ["sptk", "mel", "auto"])
def test_mcd_dtw_matches(pair, basis):
    ref, syn = PAIRS[pair]
    want = jax_mcd.mcd_dtw(ref, syn, basis=basis)
    got = port_mcd.mcd_dtw(ref, syn, basis=basis, device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 1e-4


def test_trimmed_mcd_matches():
    ref, syn = PAIRS["same_noisy"]
    ref = np.concatenate([np.zeros(4800, np.float32), ref, np.zeros(2400, np.float32)])
    want = jax_mcd.mcd_dtw(ref, syn, basis="mel", trim_silence_db=-50.0)
    got = port_mcd.mcd_dtw(ref, syn, basis="mel", trim_silence_db=-50.0, device="cpu")
    assert abs(got - want) <= 1e-4


def test_cepstra_match():
    wav = PAIRS["other_speaker"][0]
    np.testing.assert_array_equal(port_mcd.sptk_mel_cepstra(wav), jax_mcd.sptk_mel_cepstra(wav))
    c = np.random.default_rng(1).standard_normal((5, 40))
    np.testing.assert_array_equal(port_mcd._freqt(c, 13, 0.65), jax_mcd._freqt(c, 13, 0.65))
    got, want = port_mcd.mel_cepstra(wav, device="cpu"), jax_mcd.mel_cepstra(wav)
    assert got.shape == want.shape and np.abs(got - want).max() <= 2e-3


def _scores(text):
    return [float(x) for x in re.findall(r": MCD ([0-9.]+) dB", text)]


def test_compute_mcd_cli_matches(tmp_path, capsys):
    for i, (ref, syn) in enumerate(PAIRS.values()):
        write_wav(tmp_path / f"original_speaker_00{i}.wav", ref, SR)
        write_wav(tmp_path / f"generated_speaker_00{i}.wav", syn, SR)
    for basis in ("sptk", "mel"):
        jax_compute_mcd.main(["--dir", str(tmp_path), "--mcd_basis", basis])
        want = _scores(capsys.readouterr().out)
        got = compute_mcd.main(["--dir", str(tmp_path), "--mcd_basis", basis, "--device", "cpu"])
        out = capsys.readouterr().out
        assert "average MCD" in out and len(got) == len(want) == 2
        assert np.allclose(got, want, rtol=0, atol=0.006)


def test_vocoder_selftest_matches(tmp_path, capsys):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i in range(2):
        write_wav(wav_dir / f"original_speaker_00{i}.wav", clip(i, SR), SR)
    write_wav(wav_dir / "original_speaker_099.wav", np.zeros(22050, np.float32), 22050)
    cfg = VocosConfig()  # the JAX self-test builds the production widths
    with open(tmp_path / "vocos.pkl", "wb") as f:
        pickle.dump(vocos_params_to_jax(init_vocos_params(cfg, torch.Generator().manual_seed(0)), cfg), f)
    args = ["--vocoder_path", str(tmp_path / "vocos.pkl"), "--wav_dir", str(wav_dir)]
    jax_selftest.main(args)
    want = _scores(capsys.readouterr().out)
    got = selftest.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "skip (sr 22050)" in out and "average vocoder MCD" in out
    assert len(got) == len(want) == 2 and np.allclose(got, want, rtol=0, atol=0.006)
