"""The port's corpus tools against the JAX package's, run on the same files.

Each case copies one small corpus (24 kHz tones with silent leads and
tails, a filelist with and without phoneme ids, a mel cache) into two
directories, runs the JAX package's module in one and the port's copy in
the other with the same arguments, and compares what each printed (with
its directory's path replaced), every file it wrote, and its exit code.
The phonemizer is stubbed on both sides, as ``tests/test_ops_clis.py``
stubs it (eSpeak is not in this container).  Also: the config tree that
``python -m matcha_tpu_torch.train`` prints.
"""

import importlib
import shutil
from pathlib import Path

import numpy as np
import pytest

from matcha_tpu_torch.utils.audio_io import write_wav

SR = 24000


def make_corpus(root: Path) -> None:
    rng = np.random.default_rng(0)
    rows, bare = [], []
    for i in range(6):
        spk = i % 2
        rel = f"spk{spk}/u{i}"
        (root / "wavs" / f"spk{spk}").mkdir(parents=True, exist_ok=True)
        t = np.arange(int(rng.uniform(0.3, 0.9) * SR)) / SR
        tone = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
        lead, trail = np.zeros(int(rng.uniform(0.05, 0.4) * SR)), np.zeros(int(rng.uniform(0.05, 0.6) * SR))
        hiss = 1e-4 * rng.standard_normal(len(lead) + len(tone) + len(trail))
        write_wav(root / "wavs" / f"{rel}.wav", (np.concatenate([lead, tone, trail]) + hiss).astype(np.float32), SR)
        ids = " ".join(str(v) for v in rng.integers(1, 100, 12))
        text = f"‘quoted’ sample {i}" if i % 3 == 0 else f"sample {i}"
        rows.append(f"{rel}|{spk}|en-us|{text}|{ids}")
        bare.append(f"{rel}|{spk}|en-us|{text}")
        frames = int(rng.integers(20, 90))
        (root / "mels" / f"spk{spk}").mkdir(parents=True, exist_ok=True)
        np.save(root / "mels" / f"{rel}.npy", rng.standard_normal((100, frames)).astype(np.float32))
        np.save(root / "mels" / f"{rel}.fine.npy", rng.standard_normal((100, 2 * frames - 1)).astype(np.float32))
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    (root / "bare.csv").write_text("\n".join(bare) + "\n")
    (root / "mels" / "metadata.json").write_text('{"n_mels": 100}')


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_src")
    make_corpus(root)
    return root


def files_of(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def run_tool(package, module, args, corpus, tmp_path, capsys, monkeypatch):
    """(printed text with the root replaced, files after, exit code) of
    ``package.module.main(args)`` in a fresh copy of the corpus."""
    root = tmp_path / package
    shutil.copytree(corpus, root)
    mod = importlib.import_module(f"{package}.{module}")
    if hasattr(mod, "phonemize"):
        monkeypatch.setattr(mod, "phonemize", lambda text, lang: "ə" if "1" not in text else "ə☃")
    capsys.readouterr()
    code = 0
    try:
        mod.main([a.replace("{root}", str(root)) for a in args])
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return (out.out + out.err).replace(str(root), "<root>"), files_of(root), code


CASES = {
    "measure_silence_corpus": ("utils.measure_silence", ["--filelist", "{root}/train.csv", "--wav_dir", "{root}/wavs"]),
    "measure_silence_file": ("utils.measure_silence", ["--file", "{root}/wavs/spk1/u3.wav", "--threshold_db", "-50"]),
    "measure_silence_no_input": ("utils.measure_silence", []),
    "normalize_silence_out_dir": ("utils.normalize_silence", ["--filelist", "{root}/train.csv", "--wav_dir",
                                                              "{root}/wavs", "--out_dir", "{root}/norm",
                                                              "--lead_ms", "150", "--trail_ms", "300"]),
    "normalize_silence_in_place": ("utils.normalize_silence", ["--filelist", "{root}/bare.csv", "--wav_dir",
                                                               "{root}/wavs", "--in_place"]),
    "filter_by_wav_duration": ("utils.filter_by_wav_duration", ["--filelist", "{root}/train.csv", "--wav_dir",
                                                                "{root}/wavs", "--max_seconds", "1.0"]),
    "total_corpus_duration": ("utils.total_corpus_duration", ["--filelist", "{root}/train.csv", "--filelist",
                                                              "{root}/bare.csv", "--wav_dir", "{root}/wavs"]),
    "validate_corpus_ipa_with_ids": ("utils.validate_corpus_ipa", ["--filelist", "{root}/train.csv"]),
    "validate_corpus_ipa_tokenize": ("utils.validate_corpus_ipa", ["--filelist", "{root}/bare.csv"]),
    "validate_corpus_ipa_force": ("utils.validate_corpus_ipa", ["--filelist", "{root}/train.csv", "--force"]),
    "test_corpus_normalization": ("text.test_corpus_normalization", ["--filelist", "{root}/train.csv", "--limit", "1"]),
    "analyze_padding_synthetic": ("data.analyze_padding", ["--synthetic", "64", "--max_frames", "4096"]),
    "analyze_padding_corpus": ("data.analyze_padding", ["--filelist", "{root}/train.csv", "--mel_dir", "{root}/mels",
                                                        "--max_frames", "256", "--len_bucket", "16"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_matches_jax(case, corpus, tmp_path, capsys, monkeypatch):
    module, args = CASES[case]
    ref = run_tool("matcha_tpu", module, args, corpus, tmp_path, capsys, monkeypatch)
    got = run_tool("matcha_tpu_torch", module, args, corpus, tmp_path, capsys, monkeypatch)
    assert got[0] == ref[0]
    assert got[0].strip() or got[2] != 0  # every case prints something or fails
    assert got[1].keys() == ref[1].keys()
    for name in ref[1]:
        assert got[1][name] == ref[1][name], name
    assert got[2] == ref[2]


@pytest.mark.parametrize("cfg", [{"a": 1, "nested": {"b": "x", "deeper": {"c": 2.5, "d": [1, 2]}}}, {}])
def test_print_config_matches_jax(cfg, capsys):
    from matcha_tpu.utils import print_config as ref
    from matcha_tpu_torch.utils import print_config as port

    assert port.format_tree(cfg) == ref.format_tree(cfg)
    ref.print_config(cfg, title="t")
    want = capsys.readouterr().out
    port.print_config(cfg, title="t")
    assert capsys.readouterr().out == want


def test_train_entry_prints_the_config_tree(monkeypatch, capsys):
    from matcha_tpu_torch.train import __main__ as entry
    from matcha_tpu_torch.utils.configs import compose
    from matcha_tpu_torch.utils.print_config import format_tree

    class Stub:
        def fit(self, resume_from=None):
            pass

        def close(self):
            pass

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(entry, "build_trainer", lambda cfg: Stub())
    entry.main(["experiment=v20-production", "trainer.tensor_parallel=2"])
    out = capsys.readouterr().out
    assert out.startswith("┌") and "│ matcha_tpu_torch.train" in out
    cfg = compose(str(Path(entry.__file__).resolve().parents[2] / "configs" / "train.yaml"),
                  ["experiment=v20-production", "trainer.tensor_parallel=2"])
    for line in format_tree(cfg).splitlines():
        assert f"│ {line}" in out
    assert "tensor_parallel: 2" in out
