"""Port parity: the written-out optimizer against the JAX package's optax chain.

Bridged tiny params and fixed numpy gradients go through
``matcha_tpu.train.optim.build_optimizer`` (optax) and through
``matcha_tpu_torch.train.optim.AdamW``.  After each of three updates the
parameters agree to 1e-6 absolute, and Adam's moments to 1e-6 of their
largest magnitude (fp32 rounding of the same formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from matcha_tpu.train.optim import build_optimizer
from matcha_tpu.train.optim import decay_mask as jax_decay_mask
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig
from matcha_tpu_torch.weights import (
    decay_mask,
    flatten_tree,
    matcha_param_table,
    params_from_jax,
    params_to_jax,
)

CFG = tiny_config()


@pytest.fixture(scope="module")
def params():
    # jitted: one compile of the whole init instead of one per eager op
    init = jax.jit(lambda key: init_params(jax_tiny_config(), key))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), params)


def _run_both(params, cfg_kw, grad_list):
    """Apply each gradient tree in turn on both sides; yield after each step."""
    tx = build_optimizer(JaxOptimizerConfig(**cfg_kw))
    update = jax.jit(tx.update)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    tparams = params_from_jax(params, CFG)
    opt = AdamW(OptimizerConfig(**cfg_kw), decay_mask(CFG))
    ts = opt.init(tparams)
    for grads in grad_list:
        updates, js = update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tparams, params_from_jax(grads, CFG), ts)
        yield jp, js, tparams, ts


def _assert_close(jp, js, tparams, ts):
    got, want = flatten_tree(params_to_jax(tparams, CFG)), flatten_tree(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    for moment in ("mu", "nu"):
        ref = flatten_tree(jax.tree.map(np.asarray, optax.tree_utils.tree_get(js, moment)))
        ours = flatten_tree(params_to_jax(getattr(ts, moment), CFG))
        for k in ref:
            scale = max(float(np.abs(ref[k]).max()), 1e-30)
            assert float(np.abs(ours[k] - ref[k]).max()) <= 1e-6 * scale, (moment, k)


@pytest.mark.parametrize("lr", [5e-5, 1e-2])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-4])  # clipped / not clipped
def test_three_updates_match_optax(params, lr, grad_scale):
    grads = [_grads(params, s, grad_scale) for s in range(3)]
    for state in _run_both(params, {"lr": lr}, grads):
        _assert_close(*state)


def test_nonfinite_gradient_is_skipped(params):
    bad = jax.tree.map(lambda p: np.full(p.shape, np.nan, np.float32), params)
    grads = [_grads(params, 0, 1.0), bad, _grads(params, 1, 1.0)]
    before = None
    for i, (jp, js, tparams, ts) in enumerate(_run_both(params, {"lr": 1e-2}, grads)):
        _assert_close(jp, js, tparams, ts)
        now = {k: v.clone() for k, v in tparams.items()}
        if i == 1:
            assert all(torch.equal(now[k], before[k]) for k in now)
            assert int(ts.notfinite_count) == 1 and int(ts.count) == 1
        before = now
    assert int(ts.count) == 2 and int(ts.notfinite_count) == 0


def test_accumulate_grad_batches_two(params):
    grads = [_grads(params, s, 1.0) for s in range(4)]
    p0 = params_from_jax(params, CFG)
    for i, (jp, js, tparams, ts) in enumerate(
            _run_both(params, {"lr": 1e-2, "accumulate_grad_batches": 2}, grads)):
        _assert_close(jp, js, tparams, ts)
        moved = any(not torch.equal(tparams[k], p0[k]) for k in p0)
        assert moved == (i >= 1)  # the first micro-step only accumulates


def test_decay_mask_matches_jax(params):
    want = flatten_tree(jax_decay_mask(params))
    mask = decay_mask(CFG)
    for name, flax_path, _ in matcha_param_table(CFG):
        assert mask[name] == bool(want[flax_path]), name
    assert sum(mask.values()) > 10 and not all(mask.values())


def test_trainable_mask_freezes(params):
    tparams = params_from_jax(params, CFG)
    trainable = {n: n.startswith("speaker_embeddings") for n in tparams}
    opt = AdamW(OptimizerConfig(lr=1e-2), decay_mask(CFG), trainable=trainable)
    state = opt.init(tparams)
    before = {k: v.clone() for k, v in tparams.items()}
    opt.update(tparams, params_from_jax(_grads(params, 0, 1.0), CFG), state)
    for n in tparams:
        assert torch.equal(tparams[n], before[n]) != trainable[n], n
