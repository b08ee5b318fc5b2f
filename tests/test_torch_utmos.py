"""The port's UTMOS CLIs against the JAX package's, with a stubbed predictor.

The real `tarepan/SpeechMOS` predictor is a torch.hub download, so, as in
``tests/test_utmos_clis.py``, ``load_utmos`` is replaced by the same
``FakePredictor`` (a score that depends only on the call count) and
everything else runs for real on the same tiny weights: the JAX CLI from
its checkpoint, the port's from a flat checkpoint of the same parameter
tree, on the CPU.  The two print the same report, character for
character, and score every row the same number of times.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from test_utmos_clis import FakePredictor

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.train.checkpoint import save_checkpoint
from matcha_tpu.utils import utmos_short_utterances as jax_short
from matcha_tpu.utils import utmos_validate as jax_validate
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.checkpoint import save_tree
from matcha_tpu_torch.utils import utmos_short_utterances, utmos_validate


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("utmos")
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    save_checkpoint(root / "jax", {"params": params, "step": np.asarray(0)}, jax_tiny_config())
    save_tree(root / "port", {"params": params, "step": np.asarray(0)}, tiny_config())

    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        ids = " ".join(str(v) for v in rng.integers(0, 600, 8 + i))
        lang = "en-us" if i % 2 == 0 else "ro"
        text = "short text" if i < 3 else "a much longer sentence " * 3
        rows.append(f"s/u{i}|{i % 2}|{lang}|{text}|{ids}")
    filelist = root / "validate.csv"
    filelist.write_text("\n".join(rows))
    return root, filelist


def _run(cli, ckpt, filelist, extra, monkeypatch, capsys, port: bool):
    fake = FakePredictor()
    monkeypatch.setattr(cli, "load_utmos", (lambda hub_dir=None, device=None: fake) if port
                        else (lambda hub_dir=None: fake))
    cli.main(["--checkpoint_path", str(ckpt), "--vocoder_path", "", "--filelist", str(filelist),
              "--steps", "2", *extra, *(["--device", "cpu"] if port else [])])
    return capsys.readouterr().out, fake.calls


def test_utmos_validate_prints_the_jax_report(ckpts, monkeypatch, capsys):
    root, filelist = ckpts
    extra = ["--samples_per_speaker", "2"]
    want, want_calls = _run(jax_validate, root / "jax", filelist, extra, monkeypatch, capsys, port=False)
    got, calls = _run(utmos_validate, root / "port", filelist, extra, monkeypatch, capsys, port=True)
    report = [line for line in got.splitlines() if "UTMOS" in line]
    assert report == [line for line in want.splitlines() if "UTMOS" in line]
    assert report[:2] == ["speaker   0: UTMOS 3.65 (n=2)", "speaker   1: UTMOS 3.55 (n=2)"]
    assert calls == want_calls == 4


def test_utmos_short_utterances_prints_the_jax_report(ckpts, monkeypatch, capsys):
    root, filelist = ckpts
    extra = ["--short_chars", "25"]
    want, want_calls = _run(jax_short, root / "jax", filelist, extra, monkeypatch, capsys, port=False)
    got, calls = _run(utmos_short_utterances, root / "port", filelist, extra, monkeypatch, capsys, port=True)
    report = [line for line in got.splitlines() if "UTMOS" in line]
    assert report == [line for line in want.splitlines() if "UTMOS" in line]
    for lang in ("en-us", "ro"):
        assert f"{lang:>6} short: UTMOS" in got and f"{lang:>6}  long: UTMOS" in got
    assert calls == want_calls == 6
