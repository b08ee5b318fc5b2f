"""Port parity: corpus prep (``precompute_mels``, ``generate_data_statistics``)
against the JAX package's CLIs on the same corpus.

Three 24 kHz recordings cut from ``mcd_validation/`` plus one 22.05 kHz
wav that both tools must reject.  Tolerances: the two caches hold the same
file set, every array the same shape, dtype and C order and within 1e-3
(normalized log-mel: 2e-3 of log-mel over a std of 6.5, with room);
``metadata.json`` and ``failures.txt`` equal; the printed mean and std
within 1e-5 (float64 accumulation of the same sums).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from matcha_tpu.utils import generate_data_statistics as jax_stats
from matcha_tpu.utils import precompute_mels as jax_pre
from matcha_tpu.utils.audio_io import read_wav, write_wav
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.utils import generate_data_statistics as port_stats
from matcha_tpu_torch.utils import precompute_mels as port_pre

FIXTURES = Path(__file__).resolve().parent.parent / "mcd_validation"
SR = 24000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchcorpus")
    wav_dir = root / "wavs"
    (wav_dir / "spk0").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        wav, sr = read_wav(FIXTURES / f"original_speaker_00{i}.wav")
        n = int(rng.integers(SR // 2, SR))  # 0.5-1 s, ragged against both hops
        write_wav(wav_dir / f"spk0/u{i}.wav", wav[:n], sr)
        rows.append(f"spk0/u{i}|0|en-us|sample {i}|1 2 3")
    write_wav(wav_dir / "spk0/wrong_rate.wav", np.zeros(22050, np.float32), 22050)
    rows.append("spk0/wrong_rate|0|en-us|wrong rate|1 2 3")
    filelist = root / "train.csv"
    filelist.write_text("\n".join(rows))
    return root, filelist, wav_dir


@pytest.fixture(scope="module")
def caches(corpus):
    root, filelist, wav_dir = corpus
    args = ["--filelist", str(filelist), "--wav_dir", str(wav_dir)]
    jax_pre.main(args + ["--mel_dir", str(root / "jax_mels")])
    port_pre.main(args + ["--mel_dir", str(root / "port_mels"), "--device", "cpu"])
    return root / "jax_mels", root / "port_mels"


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_same_files_metadata_and_failures(caches):
    jax_dir, port_dir = caches
    assert _files(port_dir) == _files(jax_dir)
    assert "failures.txt" in _files(port_dir)
    assert json.loads((port_dir / "metadata.json").read_text()) == json.loads(
        (jax_dir / "metadata.json").read_text())
    assert (port_dir / "failures.txt").read_text() == (jax_dir / "failures.txt").read_text()
    assert "wrong_rate" in (port_dir / "failures.txt").read_text()


def test_arrays_match(caches):
    jax_dir, port_dir = caches
    npys = [f for f in _files(port_dir) if f.endswith(".npy")]
    assert len(npys) == 6
    for rel in npys:
        got, want = np.load(port_dir / rel), np.load(jax_dir / rel)
        assert got.dtype == np.float32 and got.flags.c_contiguous
        assert got.shape == want.shape and got.shape[0] == 100
        assert np.abs(got - want).max() <= 1e-3, rel


def test_port_dataset_reads_the_port_cache(corpus, caches):
    _, filelist, wav_dir = corpus
    _, port_dir = caches
    ds = TextMelDataset(filelist, port_dir)
    for i in range(3):
        item = ds[i]
        n = len(read_wav(wav_dir / f"spk0/u{i}.wav")[0])
        assert item["y"].shape == (1 + n // 256, 100)
        assert item["y_fine"].shape[0] == 2 * item["y"].shape[0] - 1
        assert ds.mel_length(i) == item["y"].shape[0]
        assert np.isfinite(item["y"]).all() and np.isfinite(item["y_fine"]).all()


def test_skips_existing_unless_overwrite(corpus, caches, capsys):
    root, filelist, wav_dir = corpus
    _, port_dir = caches
    args = ["--filelist", str(filelist), "--wav_dir", str(wav_dir), "--mel_dir", str(port_dir),
            "--device", "cpu"]
    port_pre.main(args)
    assert "written=0 skipped=3 failures=1" in capsys.readouterr().out
    port_pre.main(args + ["--overwrite"])
    assert "written=3 skipped=0 failures=1" in capsys.readouterr().out


def _stats(out: str):
    lines = dict(line.strip().split(": ") for line in out.splitlines() if ": " in line)
    return float(lines["mel_mean"]), float(lines["mel_std"])


def test_statistics_match(corpus, capsys):
    root, _, wav_dir = corpus
    filelist = root / "stats.csv"  # the 24 kHz rows only: a wrong rate is fatal here
    filelist.write_text("\n".join((root / "train.csv").read_text().splitlines()[:3]))
    args = ["--filelist", str(filelist), "--wav_dir", str(wav_dir)]
    jax_stats.main(args)
    want = _stats(capsys.readouterr().out)
    port_stats.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("data_statistics:")
    got = _stats(out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_statistics_refuse_a_cache_and_a_wrong_rate(corpus, caches):
    root, filelist, wav_dir = corpus
    _, port_dir = caches
    with pytest.raises(SystemExit, match="already exists"):
        port_stats.main(["--filelist", str(filelist), "--wav_dir", str(wav_dir),
                         "--mel_dir", str(port_dir), "--device", "cpu"])
    with pytest.raises(SystemExit, match="sample rate 22050"):
        port_stats.main(["--filelist", str(filelist), "--wav_dir", str(wav_dir), "--device", "cpu"])
