"""Port parity: one training step against the JAX package's loss + optax update.

Deterministic (no dropout) with CFM's (t, noise) fixed from numpy, on
bridged ``init_params(tiny_config(), PRNGKey(0))``: the JAX side runs
``compute_losses`` under ``jax.value_and_grad`` and
``build_optimizer(OptimizerConfig(lr=1e-3, eps=1e-3))``; the port runs
``TrainStep.train_step``.  Updated parameters agree to 1e-5 (fp32 summation
order through the whole model and the update), metrics to 1e-5 relative.

eps is raised from 1e-8 for this comparison only: Adam's first update is
lr·g/(|g| + eps), about lr·sign(g), so a gradient element at the 1e-9
level, where the two frameworks' fp32 sums differ, can take any update in
[−lr, lr] (at eps=1e-8 one element of 3072 in
decoder/down1_resnet/block2/Conv_0/kernel differs by 2.8e-4 at lr 1e-3).
tests/test_torch_optim.py holds the chain at the default eps on fixed
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from matcha_tpu.train.optim import build_optimizer
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep, make_train_step, step_seed
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, params_to_jax

CFG = tiny_config()
B, TX, TY = 4, 10, 12


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    y_lengths = rng.integers(8, TY + 1, (B,)).astype(np.int32)
    return (
        rng.integers(0, 600, (B, TX)).astype(np.int32),
        rng.integers(4, TX + 1, (B,)).astype(np.int32),
        rng.standard_normal((B, TY, CFG.n_feats)).astype(np.float32),
        y_lengths,
        rng.standard_normal((B, 2 * TY, CFG.n_feats)).astype(np.float32),
        (2 * y_lengths).astype(np.int32),
        rng.integers(0, CFG.n_spks, (B,)).astype(np.int32),
    )


@pytest.fixture(scope="module")
def params():
    # jitted: one compile of the whole init instead of one per eager op
    init = jax.jit(lambda key: init_params(jax_tiny_config(), key))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def test_one_step_matches_jax(params):
    batch = make_batch(3)
    rng = np.random.default_rng(9)
    t = rng.uniform(0.05, 0.95, (B, 1, 1)).astype(np.float32)
    noise = rng.standard_normal((B, TY, CFG.n_feats)).astype(np.float32)

    model = JaxMatchaTTS(jax_tiny_config())
    tx = build_optimizer(JaxOptimizerConfig(lr=1e-3, eps=1e-3))

    def loss_fn(p):
        out = model.apply({"params": p}, *map(jnp.asarray, batch), jax.random.PRNGKey(0),
                          deterministic=True, cfm_t_noise=(jnp.asarray(t), jnp.asarray(noise)),
                          method=JaxMatchaTTS.compute_losses)
        return out["loss"], out

    jp = jax.tree.map(jnp.asarray, params)
    (_, jl), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    updates, _ = tx.update(grads, tx.init(jp), jp)
    want = flatten_tree(jax.tree.map(np.asarray, optax.apply_updates(jp, updates)))

    ts = TrainStep(CFG, OptimizerConfig(lr=1e-3, eps=1e-3), device="cpu")
    state = ts.init_state(params_from_jax(params, CFG))
    state, metrics = ts.train_step(
        state, Batch(*map(torch.from_numpy, batch)), seed=0,
        deterministic=True, cfm_t_noise=(torch.from_numpy(t), torch.from_numpy(noise)))
    assert state.step == 1
    got = flatten_tree(params_to_jax(state.params, CFG))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)), rtol=1e-5)


def test_dropout_steps_are_seeded_and_finite(params):
    batch = Batch(*map(torch.from_numpy, make_batch(1)))
    train_step, eval_step = make_train_step(CFG, OptimizerConfig(lr=1e-3), device="cpu")
    runs = []
    for _ in range(2):
        ts = TrainStep(CFG, OptimizerConfig(lr=1e-3), device="cpu")
        state = ts.init_state(params_from_jax(params, CFG))
        losses = [float(ts.train_step(state, batch, seed=5)[1]["loss"]) for _ in range(2)]
        runs.append(losses)
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))
    assert runs[0][0] != runs[0][1]
    ev = eval_step(state.params, batch, seed=5)
    assert np.isfinite(float(ev["loss"]))


def test_step_seed_folds_step():
    assert step_seed(1, 0) != step_seed(1, 1) != step_seed(2, 1)
    assert step_seed(1, 1) == step_seed(1, 1)


def test_no_card_and_no_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(CFG, OptimizerConfig())
