"""The JAX package's CPU fp32 oracle of the hardware parity tier, and the
port held against it at full production width on the CPU.

The port's counterpart of the oracle half of ``tests/test_tpu_e2e.py``.
The card's machine has no JAX, so the oracle is written once, here, by
the JAX package on the CPU, and kept as ``tests/data/torch_e2e_oracle.npz``:

    JAX_PLATFORMS=cpu python tests/test_torch_e2e_oracle.py --write tests/data/torch_e2e_oracle.npz

It holds the inputs (40 phoneme ids; a ragged 4 x 32 x 64 training batch
and CFM's (t, noise)), the fingerprints of the weights that
``utils/hw_parity.draw_weights`` draws from numpy's legacy stream, the
JAX synthesizer's two-stage ``synthesise_ids(..., speaker=2, debug=True)``
in fp32 and in bf16 (wav, mel, durations) and its fused request's wav in
each, and one deterministic step of
``compute_losses`` + ``build_optimizer(OptimizerConfig())`` (the four
losses, ``grad_norm``, ``update_l1`` = Σ|Δw| in float64).  The card tier
(``tests/test_torch_cuda_e2e.py``) and ``chip_smoke.py`` phase
``hw_parity`` read it.

Tolerances of the port against the oracle on the CPU, each about ten times
the reading on this suite's CPU host (in brackets; ``OMP_NUM_THREADS=1
python -m matcha_tpu_torch.utils.hw_parity --device cpu`` prints them):

  fp32 synthesis   durations and wav lengths equal; mel max |Δ| / max |mel|
                   1e-5 [7.8e-7]; mel MCD 1e-3 dB [3.2e-5]; wav max |Δ|
                   5e-6 [3.6e-7]
  fp32 train step  the four losses, grad_norm and update_l1: rtol 1e-5
                   [≤ 4.6e-7]
  bf16 synthesis   the JAX tier's bf16 bars: mel MCD < 0.3 dB, durations
                   ≤ 1 frame apart on ≤ 15 % of the tokens, against the
                   JAX package's own bf16 run on the CPU [0.193 dB, equal]
                   and against the fp32 oracle [0.214 dB; the JAX
                   package's bf16 reads 0.146 dB there]
  bf16 train step  the JAX tier's bars: losses rtol 0.05, update_l1 0.10
                   [≤ 6.6e-3, 1.4e-4]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

# the writer's mode runs this file directly, without conftest's path insert
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from matcha_tpu_torch.utils import hw_parity as hp  # noqa: E402

FP32_MEL_REL_TOL = 1e-5
FP32_MEL_MCD_TOL_DB = 1e-3
FP32_WAV_TOL = 5e-6
FP32_TRAIN_RTOL = 1e-5


def _jax_synthesis(params, vparams, ids, compute_dtype: str) -> dict:
    """The JAX package's two-stage synthesis at full width (``debug=True``:
    wav, mel, durations), and its fused request's wav."""
    import dataclasses

    from matcha_tpu.inference import MatchaSynthesizer
    from matcha_tpu.models.config import MatchaConfig
    from matcha_tpu.vocoder.vocos import VocosConfig

    synth = MatchaSynthesizer(dataclasses.replace(MatchaConfig(), compute_dtype=compute_dtype), params,
                              vparams, VocosConfig(compute_dtype=compute_dtype))
    ids = [int(i) for i in ids]
    res = synth.synthesise_ids(ids, speaker=hp.SPEAKER, debug=True)
    fused = synth.synthesise_ids(ids, speaker=hp.SPEAKER, fused=True)
    return {"wav": np.asarray(res.wav), "mel": np.asarray(res.mel),
            "durations": np.asarray(res.durations), "fused_wav": np.asarray(fused.wav)}


def _jax_params():
    """The drawn weights as the JAX package's fp32 trees."""
    from matcha_tpu_torch.weights import params_to_jax, vocos_params_to_jax

    matcha, vocos = hp.draw_weights()
    cfg, vcfg = hp.configs("float32")
    return params_to_jax(matcha, cfg), vocos_params_to_jax(vocos, vcfg)


def _jax_train_step(params, batch, t, noise) -> dict:
    """One deterministic step of the JAX package's losses and optimizer."""
    import jax
    import jax.numpy as jnp
    import optax

    from matcha_tpu.models.config import MatchaConfig
    from matcha_tpu.models.matcha import MatchaTTS
    from matcha_tpu.train.optim import OptimizerConfig, build_optimizer

    model = MatchaTTS(MatchaConfig())
    tx = build_optimizer(OptimizerConfig())

    def loss_fn(p):
        out = model.apply({"params": p}, *(jnp.asarray(batch[k]) for k in hp.BATCH_FIELDS),
                          jax.random.PRNGKey(5), deterministic=True,
                          cfm_t_noise=(jnp.asarray(t), jnp.asarray(noise)),
                          method=MatchaTTS.compute_losses)
        return out["loss"], out

    jp = jax.tree.map(jnp.asarray, params)
    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    updates, _ = tx.update(grads, tx.init(jp), jp)
    new = optax.apply_updates(jp, updates)
    update_l1 = sum(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum()
                    for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(jp)))
    return {"loss": float(aux["loss"]), "sub_loss/diff": float(aux["diff_loss"]),
            "sub_loss/dur": float(aux["dur_loss"]), "sub_loss/prior": float(aux["prior_loss"]),
            "grad_norm": float(optax.global_norm(grads)), "update_l1": float(update_l1)}


def write_oracle(path: str) -> None:
    """The JAX package's CPU run at the operating point, with its inputs."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", "the oracle is the CPU's"
    matcha, vocos = hp.draw_weights()
    params, vparams = _jax_params()
    ids = hp.phoneme_ids()
    batch = hp.train_batch_arrays()
    t, noise = hp.train_t_noise()
    out = {"ids": ids, "weight_seed": np.int64(hp.WEIGHT_SEED),
           "fingerprint_matcha": np.float64(hp.fingerprint(matcha)),
           "fingerprint_vocos": np.float64(hp.fingerprint(vocos)),
           **{"batch_" + k: v for k, v in batch.items()}, "train_t": t, "train_noise": noise,
           "jax_version": np.str_(jax.__version__), "numpy_version": np.str_(np.__version__)}
    for dtype, name in (("float32", "fp32"), ("bfloat16", "bf16")):
        for k, v in _jax_synthesis(params, vparams, ids, dtype).items():
            out[f"{name}_{k}"] = v
    for k, v in _jax_train_step(params, batch, t, noise).items():
        out["train_" + k.replace("/", "_")] = np.float64(v)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"oracle written: {path} ({Path(path).stat().st_size} bytes) backend={jax.default_backend()}")


@pytest.fixture(scope="module")
def oracle():
    assert hp.ORACLE_PATH.exists(), f"{hp.ORACLE_PATH} is missing: write it with this file's --write"
    return hp.load_oracle()


@pytest.fixture(scope="module")
def port_fp32(oracle):
    synth = hp.build_synthesizer("cpu", "float32")
    return hp.synth_point("cpu", "float32", ids=oracle["ids"], synth=synth)


@pytest.fixture(scope="module")
def port_bf16(oracle):
    return hp.synth_point("cpu", "bfloat16", ids=oracle["ids"])


def test_oracle_file_and_fingerprints(oracle):
    for key in ("ids", "fingerprint_matcha", "fingerprint_vocos", "train_t", "train_noise",
                *("batch_" + k for k in hp.BATCH_FIELDS),
                *(f"{d}_{k}" for d in ("fp32", "bf16") for k in ("wav", "mel", "durations", "fused_wav")),
                "train_loss", "train_grad_norm", "train_update_l1", "jax_version", "numpy_version"):
        assert key in oracle, key
    assert oracle["ids"].shape == (hp.N_TOKENS,)
    assert oracle["batch_y"].shape == (hp.TRAIN_B, hp.TRAIN_TY, 100)
    assert hp.ORACLE_PATH.stat().st_size < 1 << 20
    # a fresh draw gives the file's weights (raises otherwise)
    hp.check_fingerprints(oracle)
    np.testing.assert_array_equal(oracle["ids"], hp.phoneme_ids())


def test_fingerprint_tells_weights_apart():
    matcha, _ = hp.draw_weights()
    other = dict(matcha)
    name = "decoder.estimator.final_proj.weight"
    other[name] = matcha[name] * (1 + 1e-6)
    assert hp.fingerprint(other) != hp.fingerprint(matcha)


def test_port_fp32_synthesis_reproduces_oracle(oracle, port_fp32):
    ref = hp.oracle_synthesis(oracle, "fp32")
    cmp = hp.compare_synthesis(ref, port_fp32)
    np.testing.assert_array_equal(port_fp32["durations"], ref["durations"])
    assert len(port_fp32["wav"]) == len(ref["wav"])
    assert cmp["mel_rel_max_abs_diff"] <= FP32_MEL_REL_TOL, cmp
    assert cmp["mel_mcd_db"] <= FP32_MEL_MCD_TOL_DB, cmp
    assert np.abs(port_fp32["wav"] - ref["wav"]).max() <= FP32_WAV_TOL


def test_port_fp32_train_step_reproduces_oracle(oracle):
    batch, t_noise = hp.oracle_batch(oracle)
    got = hp.train_step_point("cpu", "float32", batch, t_noise)
    rel = hp.train_rel_diffs(hp.oracle_train(oracle), got)
    assert max(rel.values()) <= FP32_TRAIN_RTOL, rel


def test_port_bf16_against_jax_bf16(oracle, port_bf16):
    cmp = hp.compare_synthesis(hp.oracle_synthesis(oracle, "bf16"), port_bf16)
    assert cmp["mel_mcd_db"] < hp.MEL_MCD_BF16_BAR_DB, cmp
    assert cmp["durations"]["max_abs_diff"] <= hp.DURATION_MAX_DIFF, cmp
    assert cmp["durations"]["fraction_differ"] <= hp.DURATION_DIFF_FRACTION, cmp


def test_port_bf16_against_fp32_oracle(oracle, port_bf16):
    cmp = hp.compare_synthesis(hp.oracle_synthesis(oracle, "fp32"), port_bf16)
    assert cmp["mel_mcd_db"] < hp.MEL_MCD_BF16_BAR_DB, cmp
    assert cmp["durations"]["max_abs_diff"] <= hp.DURATION_MAX_DIFF, cmp
    assert cmp["durations"]["fraction_differ"] <= hp.DURATION_DIFF_FRACTION, cmp


def test_port_bf16_train_step_against_oracle(oracle):
    batch, t_noise = hp.oracle_batch(oracle)
    got = hp.train_step_point("cpu", "bfloat16", batch, t_noise)
    rel = hp.train_rel_diffs(hp.oracle_train(oracle), got)
    assert all(rel[k] <= hp.TRAIN_LOSS_RTOL for k in hp.LOSS_KEYS), rel
    assert np.isfinite(got["grad_norm"])
    assert rel["update_l1"] <= hp.UPDATE_L1_RTOL, rel


def test_cli_readings_on_cpu_meet_the_bars(oracle, capsys):
    """``python -m matcha_tpu_torch.utils.hw_parity --device cpu``: every
    comparison of the card's tier, run by the port on the CPU, within the
    JAX tier's bars."""
    import json

    assert hp.main(["--device", "cpu"]) == 0
    readings = json.loads(capsys.readouterr().out)
    assert readings["bar_misses"] == [] and readings["device"] == "cpu"
    assert readings["fp32_vs_fp32_oracle"]["mel_mcd_db"] <= FP32_MEL_MCD_TOL_DB


def test_oracle_is_the_jax_packages(oracle):
    """The file's fp32 synthesis is what the JAX package computes now."""
    params, vparams = _jax_params()
    got = _jax_synthesis(params, vparams, oracle["ids"], "float32")
    ref = hp.oracle_synthesis(oracle, "fp32")
    np.testing.assert_array_equal(got["durations"], ref["durations"])
    np.testing.assert_allclose(got["mel"], ref["mel"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["wav"], ref["wav"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["fused_wav"], oracle["fp32_fused_wav"], rtol=0, atol=1e-6)


if __name__ == "__main__":
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", required=True, help="where to write the oracle (.npz)")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write_oracle(args.write)
