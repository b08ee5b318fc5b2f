"""``utils/hw_parity.py`` and ``utils/hw_gate.py`` on the CPU: the inputs
and the distance are the JAX tier's (``tests/test_tpu_e2e.py``), the
weights' scheme is ``random_state_dict``'s, and the gate's parsers read
pytest's output.  The full-width comparisons are in
``tests/test_torch_e2e_oracle.py``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.layers import random_state_dict
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.utils import hw_gate
from matcha_tpu_torch.utils import hw_parity as hp

TESTS = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def jax_tier():
    """``tests/test_tpu_e2e.py`` as a module (its helpers run on the CPU)."""
    spec = importlib.util.spec_from_file_location("jax_tpu_e2e_tier", TESTS / "test_tpu_e2e.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_operating_point_is_the_jax_tiers(jax_tier):
    assert (hp.N_TOKENS, hp.TRAIN_B, hp.TRAIN_TX, hp.TRAIN_TY) == (
        jax_tier.N_TOKENS, jax_tier.TRAIN_B, jax_tier.TRAIN_TX, jax_tier.TRAIN_TY)
    assert (hp.MEL_MCD_FP32_BAR_DB, hp.MEL_MCD_BF16_BAR_DB, hp.FUSED_MCD_BAR_DB, hp.TRAIN_LOSS_RTOL) == (
        jax_tier.MEL_MCD_FP32_BAR_DB, jax_tier.MEL_MCD_BF16_BAR_DB, jax_tier.FUSED_MCD_BAR_DB,
        jax_tier.TRAIN_LOSS_RTOL)


def test_phoneme_ids_are_the_jax_tiers(jax_tier):
    np.testing.assert_array_equal(hp.phoneme_ids(), jax_tier._phoneme_ids())


def test_train_batch_is_the_jax_tiers(jax_tier):
    want = jax_tier._train_batch()
    got = hp.train_batch_arrays()
    for name in hp.BATCH_FIELDS:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)), err_msg=name)
        assert got[name].dtype == np.asarray(getattr(want, name)).dtype, name


@pytest.mark.parametrize("seed", [0, 1])
def test_mel_mcd_db_is_the_jax_tiers(jax_tier, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((30, 100)) - 5.0
    b = a + 0.05 * rng.standard_normal((33, 100))[:30]
    b = np.concatenate([b, b[-3:]])  # a length the DTW must absorb
    assert hp.mel_mcd_db(a, b) == pytest.approx(jax_tier.mel_mcd_db(a, b), rel=1e-12)
    assert hp.mel_mcd_db(a, a) == pytest.approx(0.0, abs=1e-6)


def test_random_state_weights_follow_the_scheme():
    """The RandomState draw is reproducible, and every rule of the scheme
    but the normal draws gives what the torch-generator draw gives."""
    module = MatchaTTS(tiny_config())
    a = random_state_dict(module, np.random.RandomState(3))
    b = random_state_dict(module, np.random.RandomState(3))
    c = random_state_dict(module, torch.Generator().manual_seed(3))
    d = random_state_dict(module, torch.Generator().manual_seed(4))
    assert list(a) == list(c)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
        assert a[name].dtype == torch.float32 and a[name].shape == c[name].shape
        if torch.equal(c[name], d[name]):  # ones, zeros, the identity FiLM, layer scale
            torch.testing.assert_close(a[name], c[name], rtol=0, atol=0, msg=name)
    w = a["decoder.estimator.final_proj.weight"]
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.25


def test_fingerprint_is_float64_sum_of_abs():
    state = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([[0.5]])}
    assert hp.fingerprint(state) == 3.5


def test_duration_stats_and_compare():
    ref = np.array([1, 1, 2, 4], np.float32)
    got = np.array([1, 2, 2, 4], np.float32)
    stats = hp.duration_stats(ref, got)
    assert stats["max_abs_diff"] == 1.0 and stats["fraction_differ"] == 0.25
    assert stats["histogram"] == {"1": 2, "2": 1, "4": 1}
    with pytest.raises(ValueError):
        hp.duration_stats(ref, got[:3])
    mel = np.random.default_rng(0).standard_normal((12, 100)) - 5
    cmp = hp.compare_synthesis({"wav": np.zeros(10), "mel": mel, "durations": ref},
                               {"wav": np.zeros(10), "mel": mel, "durations": ref})
    assert cmp["mel_rel_max_abs_diff"] == 0.0 and cmp["durations"]["fraction_differ"] == 0.0


def test_train_rel_diffs():
    ref = {k: 2.0 for k in hp.TRAIN_KEYS}
    got = dict(ref, loss=2.1)
    rel = hp.train_rel_diffs(ref, got)
    assert rel["loss"] == pytest.approx(0.05) and rel["update_l1"] == 0.0


def test_oracle_round_trip_helpers(tmp_path):
    """oracle_batch / oracle_synthesis / oracle_train read the writer's keys."""
    batch = hp.train_batch_arrays()
    t, noise = hp.train_t_noise()
    data = {**{"batch_" + k: v for k, v in batch.items()}, "train_t": t, "train_noise": noise,
            **{f"fp32_{k}": np.zeros(3) for k in ("wav", "mel", "durations")},
            **{"train_" + k.replace("/", "_"): np.float64(1.5) for k in hp.TRAIN_KEYS}}
    path = tmp_path / "o.npz"
    np.savez_compressed(path, **data)
    oracle = hp.load_oracle(path)
    got_batch, (got_t, got_noise) = hp.oracle_batch(oracle)
    np.testing.assert_array_equal(got_batch["y_fine"], batch["y_fine"])
    np.testing.assert_array_equal(got_noise, noise)
    assert set(hp.oracle_synthesis(oracle, "fp32")) == {"wav", "mel", "durations"}
    assert hp.oracle_train(oracle)["sub_loss/prior"] == 1.5


GATE_OUT = """\
[card-e2e] two-stage fp32 vs fp32 oracle: MCD 0.0012 dB, duration_max_diff 0
.
[card-e2e] two-stage bf16 vs fp32 oracle: MCD 0.1790 dB
[card-e2e] train step bf16 vs fp32 oracle: rel_loss 0.00123, rel_update_l1 4.5e-05
...
5 passed, 1 skipped in 41.20s
"""


def test_hw_gate_parses_readings_and_counts():
    mcd, other = hw_gate.parse_readings(GATE_OUT)
    assert mcd == {"two-stage fp32 vs fp32 oracle": 0.0012, "two-stage bf16 vs fp32 oracle": 0.179}
    assert other["two-stage fp32 vs fp32 oracle"] == {"duration_max_diff": 0.0}
    assert other["train step bf16 vs fp32 oracle"] == {"rel_loss": 0.00123, "rel_update_l1": 4.5e-05}
    assert hw_gate.parse_counts(GATE_OUT) == {"passed": 5, "failed": 0, "skipped": 1, "errors": 0}
    assert hw_gate.parse_counts("1 failed, 2 passed, 1 error in 3s")["errors"] == 1
    assert hw_gate.parse_counts("no tests ran") == {"passed": 0, "failed": 0, "skipped": 0, "errors": 0}


def test_hw_gate_tiers_are_the_card_tests():
    for _, paths in hw_gate.TIERS:
        for p in paths:
            assert (hw_gate.REPO / p).exists(), p


def test_hw_gate_writes_its_artifact_when_a_tier_times_out(tmp_path, monkeypatch):
    """A tier past its timeout is a failed tier with its output's tail; the
    gate still writes the JSON artifact and exits 1."""
    import json
    import subprocess

    def run(cmd, timeout=None, **_):
        raise subprocess.TimeoutExpired(cmd, timeout, output="collected 6 items\n..", stderr=b"still running")

    monkeypatch.setattr(hw_gate.subprocess, "run", run)
    tier = hw_gate.run_tier("cuda_e2e", ["tests/test_torch_cuda_e2e.py"], 0.5)
    assert tier["ok"] is False and tier["returncode"] is None and tier["timed_out"] is True
    assert "collected 6 items" in tier["tail"] and "still running" in tier["tail"]

    monkeypatch.setattr(hw_gate, "card", lambda: {"name": "stub"})
    out = tmp_path / "gate.json"
    assert hw_gate.main(["--out", str(out), "--timeout", "0.5"]) == 1
    report = json.loads(out.read_text())
    assert report["ok"] is False
    assert all(t["timed_out"] and not t["ok"] for t in report["tiers"].values())


def test_hw_gate_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        hw_gate.main(["--out", str(tmp_path / "gate.json")])
    assert not (tmp_path / "gate.json").exists()


def _readings():
    """``parity_readings``' shape, every reading inside its bar."""
    def cmp(mcd, n=5888):
        return {"mel_mcd_db": mcd, "wav_samples": [5888, n],
                "durations": {"max_abs_diff": 0.0, "fraction_differ": 0.0, "histogram": {"1": 40}}}
    return {"fp32_vs_fp32_oracle": cmp(1e-4), "bf16_vs_fp32_oracle": cmp(0.16),
            "fused_vs_two_stage_mcd_db": 0.1, "fused_wav_samples": [5888, 5888],
            **{name: {k: 1.0 for k in hp.TRAIN_KEYS} for name in ("train", "train_fp32")},
            **{name: {k: 1e-3 for k in hp.TRAIN_KEYS}
               for name in ("train_rel_diff", "train_fp32_rel_diff")}}


def _set(r, path, value):
    *parents, leaf = path
    for p in parents:
        r = r[p]
    r[leaf] = value


@pytest.mark.parametrize("path,value", [
    (("fp32_vs_fp32_oracle", "mel_mcd_db"), 0.1),
    (("fp32_vs_fp32_oracle", "wav_samples"), [5888, 5632]),
    (("bf16_vs_fp32_oracle", "mel_mcd_db"), 0.31),
    (("bf16_vs_fp32_oracle", "wav_samples"), [5888, 5888 + 2048]),
    (("bf16_vs_fp32_oracle", "durations", "max_abs_diff"), 2.0),
    (("bf16_vs_fp32_oracle", "durations", "fraction_differ"), 0.2),
    (("fused_vs_two_stage_mcd_db",), 0.15),
    (("fused_wav_samples",), [5888, 6144]),
    (("train", "grad_norm"), float("nan")),
    (("train_rel_diff", "sub_loss/dur"), 0.06),
    (("train_rel_diff", "update_l1"), 0.11),
    (("train_fp32", "loss"), float("inf")),
    (("train_fp32_rel_diff", "loss"), 0.051),
])
def test_bar_misses_names_each_miss(path, value):
    r = _readings()
    assert hp.bar_misses(r) == []
    _set(r, path, value)
    assert len(hp.bar_misses(r)) == 1
