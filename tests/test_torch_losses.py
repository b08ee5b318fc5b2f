"""Port parity: the training losses and their gradients against the JAX package.

Bridged ``init_params(tiny_config(), PRNGKey(0))`` weights, the golden
fingerprint batch of ``tests/test_golden_regression.py`` and CFM's (t,
noise) drawn with JAX from PRNGKey(7) exactly as ``cfm_loss`` draws them,
handed to both sides.  Tolerances: losses 1e-5 against JAX (fp32 summation
order) and 2e-3 against ``tests/fixtures/golden_losses.json`` (the fixture's
own tolerance); every parameter's gradient within max|err| / max|ref| of
1e-4; quantile diagnostics 1e-6.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.matcha import log_prior_scores as jax_log_prior_scores
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import MatchaTTS, linear_quantiles, log_prior_scores
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, params_to_jax

CFG = tiny_config()
GOLDEN = Path(__file__).parent / "fixtures" / "golden_losses.json"
LOSS_KEYS = ("loss", "diff_loss", "dur_loss", "prior_loss")


def fingerprint_batch():
    """The batch of tests/test_golden_regression.py, as numpy arrays."""
    rng = np.random.default_rng(1234)
    b, tx, ty = 2, 10, 12
    return (
        rng.integers(0, 600, (b, tx)).astype(np.int32),
        np.asarray([tx, tx - 3], np.int32),
        rng.standard_normal((b, ty, CFG.n_feats)).astype(np.float32),
        np.asarray([ty, ty - 4], np.int32),
        rng.standard_normal((b, 2 * ty, CFG.n_feats)).astype(np.float32),
        np.asarray([2 * ty, 2 * (ty - 4)], np.int32),
        np.asarray([0, 1], np.int32),
    )


def jax_t_noise(shape, key=7):
    """(t, noise) as ``cfm_loss`` draws them from PRNGKey(key)."""
    rng_t, rng_x0 = jax.random.split(jax.random.PRNGKey(key))
    t = jax.random.uniform(rng_t, (shape[0], 1, 1), dtype=jnp.float32)
    return np.array(t), np.array(jax.random.normal(rng_x0, shape, dtype=jnp.float32))


@pytest.fixture(scope="module")
def params():
    # jitted: one compile of the whole init instead of one per eager op
    init = jax.jit(lambda key: init_params(jax_tiny_config(), key))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def jax_losses_and_grads(params, batch, t_noise, weights=None):
    model = JaxMatchaTTS(jax_tiny_config())

    def loss_fn(p):
        out = model.apply({"params": p}, *map(jnp.asarray, batch), jax.random.PRNGKey(0),
                          deterministic=True, cfm_t_noise=tuple(map(jnp.asarray, t_noise)),
                          row_weights=None if weights is None else jnp.asarray(weights),
                          method=JaxMatchaTTS.compute_losses)
        return out["loss"], out

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, grads)


def torch_losses_and_grads(params, batch, t_noise, weights=None):
    model = MatchaTTS(CFG)
    model.load_state_dict(params_from_jax(params, CFG))
    tb = [torch.from_numpy(np.asarray(a)) for a in batch]
    losses = model.compute_losses(*tb, deterministic=True,
                                  cfm_t_noise=tuple(torch.from_numpy(a) for a in t_noise),
                                  row_weights=None if weights is None else torch.from_numpy(weights))
    losses["loss"].backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return {k: v.detach().numpy() for k, v in losses.items()}, params_to_jax(grads, CFG)


@pytest.fixture(scope="module")
def both(params):
    batch = fingerprint_batch()
    t_noise = jax_t_noise(batch[2].shape)
    return jax_losses_and_grads(params, batch, t_noise), torch_losses_and_grads(params, batch, t_noise)


def test_log_prior_scores_match_jax():
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((2, 7, 8)).astype(np.float32)
    y = rng.standard_normal((2, 19, 8)).astype(np.float32)
    ours = log_prior_scores(torch.from_numpy(mu), torch.from_numpy(y)).numpy()
    ref = np.asarray(jax_log_prior_scores(jnp.asarray(mu), jnp.asarray(y)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", LOSS_KEYS + ("mas_frames",))
def test_losses_match_jax(both, key):
    (jl, _), (tl, _) = both
    np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ("diff_loss", "dur_loss", "prior_loss"))
def test_losses_match_golden_fixture(both, key):
    _, (tl, _) = both
    golden = json.loads(GOLDEN.read_text())
    assert abs(round(float(tl[key]), 4) - golden[key]) < 2e-3


def test_every_gradient_matches_jax(both):
    (_, jg), (_, tg) = both
    ref, got = flatten_tree(jg), flatten_tree(tg)
    assert set(ref) == set(got)
    worst = {}
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        err = float(np.abs(got[k] - ref[k]).max())
        worst[k] = err / scale if scale > 0 else err
    bad = {k: v for k, v in worst.items() if v > 1e-4}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    # the gradient reaches every part of the model
    assert flatten_tree(jg)["decoder/final_proj/kernel"].any()
    assert flatten_tree(jg)["encoder/proj_w/Conv_0/kernel"].any()


@pytest.mark.parametrize("name", ["duration", "prior"])
def test_quantile_diagnostics_match_jax(both, name):
    (jl, _), (tl, _) = both
    for q in (0.5, 0.9, 0.99):
        key = f"abs_error_quantiles/{name}_{q}"
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_linear_quantiles_match_jnp_quantile(n):
    x = np.random.default_rng(n).standard_normal((n,)).astype(np.float32)
    qs = (0.5, 0.9, 0.99)
    ours = [float(v) for v in linear_quantiles(torch.from_numpy(x), qs)]
    ref = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(qs)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_repeat_fill_is_gradient_neutral(params):
    """Mirrors tests/test_train_step.py::TestRepeatFillNeutrality: rows that
    repeat the batch with weight 0 leave losses and gradients unchanged."""
    rng = np.random.default_rng(3)
    b_real, b_full, tx, ty = 2, 4, 10, 12
    y_lengths = rng.integers(8, ty + 1, (b_real,)).astype(np.int32)
    real = (
        rng.integers(0, 600, (b_real, tx)).astype(np.int32),
        rng.integers(4, tx + 1, (b_real,)).astype(np.int32),
        rng.standard_normal((b_real, ty, CFG.n_feats)).astype(np.float32),
        y_lengths,
        rng.standard_normal((b_real, 2 * ty, CFG.n_feats)).astype(np.float32),
        (2 * y_lengths).astype(np.int32),
        rng.integers(0, CFG.n_spks, (b_real,)).astype(np.int32),
    )
    t = rng.uniform(0.1, 0.9, (b_real, 1, 1)).astype(np.float32)
    noise = rng.standard_normal((b_real, ty, CFG.n_feats)).astype(np.float32)

    def fill(a):
        return np.concatenate([a, a[: b_full - b_real]], axis=0)

    w = np.asarray([1.0] * b_real + [0.0] * (b_full - b_real), np.float32)
    la, ga = torch_losses_and_grads(params, real, (t, noise), np.ones((b_real,), np.float32))
    lb, gb = torch_losses_and_grads(params, tuple(map(fill, real)), (fill(t), fill(noise)), w)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(la[k], lb[k], rtol=1e-5, atol=1e-6, err_msg=k)
    fa, fb = flatten_tree(ga), flatten_tree(gb)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=2e-4, atol=1e-6, err_msg=k)
