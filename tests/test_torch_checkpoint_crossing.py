"""Optimizer state across the frameworks: JAX trainer checkpoints resumed by
the port, port checkpoints resumed by the JAX trainer, and orbax through
``tools/convert_orbax_checkpoint.py``.

The JAX side is a trainer state at ``tiny_config()`` (random weights, drawn
by the port and bridged into the flax layout) with
``accumulate_grad_batches=2`` and a trainable mask that freezes the
encoder's embedding table, so every node of the optax chain holds state
(MultiSteps, apply_if_finite, the masked chain, Adam); it takes three steps
(deterministic, CFM's t and noise fixed from numpy), so Adam has applied one
update and the accumulator holds one gradient.  Tolerances: what a
checkpoint carries crosses bit for bit; one port step against one JAX step
from the same state as ``tests/test_torch_train_step.py`` holds it (Adam eps
1e-3, parameters 1e-5 absolute, fp32 summation order), Adam's moments
within max|err| / max|ref| of 1e-4 (the gradients' tolerance of
``tests/test_torch_losses.py``), counters exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu.models.config import MatchaConfig as JaxMatchaConfig
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.train import checkpoint as jax_checkpoint
from matcha_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from matcha_tpu.train.optim import build_optimizer
from matcha_tpu.train.step import init_train_state
from matcha_tpu_torch.checkpoint import flatten_keystr, load_checkpoint
from matcha_tpu_torch.models.config import MatchaConfig, tiny_config
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.models.matcha import init_params as port_init_params
from matcha_tpu_torch.train import checkpoint as port_ckpt
from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainState, TrainStep
from matcha_tpu_torch.weights import decay_mask, flatten_tree, params_to_jax
from tools.convert_orbax_checkpoint import to_flat, to_orbax

CFG = tiny_config()
B, TX, TY = 4, 10, 12
FROZEN_PATH, FROZEN_NAME = ("encoder", "emb", "embedding"), "encoder.emb.weight"
PINNED = Path(__file__).parent / "fixtures" / "jax_trainer_opt_state_keys.json"
OPT = dict(lr=1e-3, eps=1e-3, accumulate_grad_batches=2)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    y_lengths = rng.integers(8, TY + 1, (B,)).astype(np.int32)
    batch = (
        rng.integers(0, 600, (B, TX)).astype(np.int32),
        rng.integers(4, TX + 1, (B,)).astype(np.int32),
        rng.standard_normal((B, TY, CFG.n_feats)).astype(np.float32),
        y_lengths,
        rng.standard_normal((B, 2 * TY, CFG.n_feats)).astype(np.float32),
        (2 * y_lengths).astype(np.int32),
        rng.integers(0, CFG.n_spks, (B,)).astype(np.int32),
    )
    t = rng.uniform(0.05, 0.95, (B, 1, 1)).astype(np.float32)
    noise = rng.standard_normal((B, TY, CFG.n_feats)).astype(np.float32)
    return batch, t, noise


def jax_optimizer(params):
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: tuple(k.key for k in path) != FROZEN_PATH, params)
    return build_optimizer(JaxOptimizerConfig(**OPT), trainable_mask=mask)


def port_step():
    trainable = {n: n != FROZEN_NAME for n in decay_mask(CFG)}
    return TrainStep(CFG, OptimizerConfig(**OPT), device="cpu", trainable=trainable)


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_run():
    """(tx, jitted step, the state after 3 steps, the state after 4)."""
    params = jax.tree.map(jnp.asarray, params_to_jax(port_init_params(CFG, torch.Generator().manual_seed(0)), CFG))
    tx = jax_optimizer(params)
    model = JaxMatchaTTS(jax_tiny_config())

    @jax.jit
    def step(params, opt_state, batch, t, noise):
        def loss_fn(p):
            return model.apply({"params": p}, *batch, jax.random.PRNGKey(0), deterministic=True,
                               cfm_t_noise=(t, noise), method=JaxMatchaTTS.compute_losses)["loss"]

        grads = jax.grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    states = [{"params": params, "opt_state": tx.init(params)}]
    for k in range(4):
        batch, t, noise = make_batch(k)
        p, o = step(states[-1]["params"], states[-1]["opt_state"], tuple(map(jnp.asarray, batch)),
                    jnp.asarray(t), jnp.asarray(noise))
        states.append({"params": p, "opt_state": o})
    as_tree = [jax.tree.map(np.asarray, dict(s, step=k, epoch=0)) for k, s in enumerate(states)]
    return tx, step, as_tree[3], as_tree[4]


def write_flat_jax(path, tree):
    """The JAX trainer's no-orbax writer (which needs its directory made)."""
    path.mkdir(parents=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_checkpoint, "_HAS_ORBAX", False)
        jax_checkpoint.save_checkpoint(path, tree, jax_tiny_config())


def jax_flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_state_equals_jax(state: TrainState, tree):
    """Every leaf the port resumed equals the JAX tree's, bit for bit."""
    opt = tree["opt_state"]
    adam = opt.inner_opt_state.inner_state[0][1][0]
    finite = opt.inner_opt_state
    assert state.step == int(tree["step"])
    for got, want in ((state.params, tree["params"]), (state.opt_state.mu, adam.mu),
                      (state.opt_state.nu, adam.nu), (state.opt_state.acc_grads, opt.acc_grads)):
        got_flat, want_flat = flatten_tree(params_to_jax(got, CFG)), flatten_tree(want)
        assert set(got_flat) == set(want_flat)
        for k in want_flat:
            np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    o = state.opt_state
    assert int(o.count) == int(adam.count) == 1
    assert (o.mini_step, o.gradient_step) == (int(opt.mini_step), int(opt.gradient_step)) == (1, 1)
    assert int(o.notfinite_count) == int(finite.notfinite_count)
    assert bool(o.last_finite) == bool(finite.last_finite)
    assert int(o.total_notfinite) == int(finite.total_notfinite)


def resumed(path, ts) -> TrainState:
    tree, cfg = load_checkpoint(path)
    params, opt_state, step, _ = port_ckpt.train_state_from_tree(tree, cfg, "cpu")
    return TrainState(params, opt_state, step)


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    _, _, after3, after4 = jax_run
    write_flat_jax(tmp_path / "jax3", after3)
    ts = port_step()
    state = resumed(tmp_path / "jax3", ts)
    assert_state_equals_jax(state, after3)

    batch, t, noise = make_batch(3)
    ts.train_step(state, Batch(*map(torch.from_numpy, batch)), seed=0, deterministic=True,
                  cfm_t_noise=(torch.from_numpy(t), torch.from_numpy(noise)))
    opt, adam = after4["opt_state"], after4["opt_state"].inner_opt_state.inner_state[0][1][0]
    got = flatten_tree(params_to_jax(state.params, CFG))
    for k, want in flatten_tree(after4["params"]).items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5, err_msg=k)
    for moments, want in ((state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        got = flatten_tree(params_to_jax(moments, CFG))
        for k, w in flatten_tree(want).items():
            assert rel_err(got[k], w) <= 1e-4, k
    assert int(state.opt_state.count) == int(adam.count) == 2
    assert (state.opt_state.mini_step, state.opt_state.gradient_step) == (
        int(opt.mini_step), int(opt.gradient_step)) == (0, 2)
    # the frozen table moved in neither framework
    np.testing.assert_array_equal(flatten_tree(params_to_jax(state.params, CFG))["encoder/emb/embedding"],
                                  after3["params"]["encoder"]["emb"]["embedding"])


def test_port_checkpoint_has_the_jax_trainer_keys(jax_run, tmp_path):
    _, _, after3, _ = jax_run
    write_flat_jax(tmp_path / "jax3", after3)
    ts = port_step()
    state = resumed(tmp_path / "jax3", ts)
    port_ckpt.save_checkpoint(tmp_path / "port", state.params, state.opt_state, state.step, 0, CFG,
                              optimizer=ts.opt)
    with np.load(tmp_path / "port" / "state.npz") as got, np.load(tmp_path / "jax3" / "state.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_checkpoint_resumes_in_the_jax_trainer_through_orbax(jax_run, tmp_path):
    tx, step, after3, _ = jax_run
    write_flat_jax(tmp_path / "jax3", after3)
    ts = port_step()
    state = resumed(tmp_path / "jax3", ts)
    batch, t, noise = make_batch(3)
    ts.train_step(state, Batch(*map(torch.from_numpy, batch)), seed=0, deterministic=True,
                  cfm_t_noise=(torch.from_numpy(t), torch.from_numpy(noise)))
    port_ckpt.save_checkpoint(tmp_path / "port", state.params, state.opt_state, state.step, 0, CFG,
                              optimizer=ts.opt)
    to_orbax(tmp_path / "port", tmp_path / "orbax")
    assert (tmp_path / "orbax" / "state").is_dir()

    params0 = after3["params"]
    template = {"params": params0, "opt_state": tx.init(params0), "step": 0, "epoch": 0}
    tree, _ = jax_checkpoint.load_checkpoint(tmp_path / "orbax", target=template)
    adam = tree["opt_state"].inner_opt_state.inner_state[0][1][0]
    for moments, want in ((state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu),
                          (state.params, tree["params"])):
        got, want = flatten_tree(params_to_jax(moments, CFG)), flatten_tree(jax.tree.map(np.asarray, want))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(tree["step"]) == 4 and int(adam.count) == 2
    # the JAX trainer's step takes the restored state as it is
    batch, t, noise = make_batch(4)
    p, o = step(tree["params"], tree["opt_state"], tuple(map(jnp.asarray, batch)), jnp.asarray(t),
                jnp.asarray(noise))
    assert int(o.mini_step) == 1 and all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(p))


def test_orbax_checkpoint_converts_to_flat_and_resumes(jax_run, tmp_path):
    _, _, after3, _ = jax_run
    jax_checkpoint.save_checkpoint(tmp_path / "orbax", after3, jax_tiny_config())
    assert (tmp_path / "orbax" / "state").is_dir()
    to_flat(tmp_path / "orbax", tmp_path / "flat")
    with np.load(tmp_path / "flat" / "state.npz") as data:
        assert sorted(data.files) == sorted(jax_flat(after3))
    state = resumed(tmp_path / "flat", port_step())
    assert_state_equals_jax(state, after3)


def test_orbax_directory_refusal_names_the_converter(tmp_path):
    (tmp_path / "state").mkdir()
    (tmp_path / "config.json").write_text(json.dumps(jax_tiny_config().to_dict()))
    with pytest.raises(NotImplementedError, match="convert_orbax_checkpoint.py --to-flat"):
        load_checkpoint(tmp_path)


def test_earlier_port_layout_is_still_read(tmp_path):
    ts = TrainStep(CFG, OptimizerConfig(accumulate_grad_batches=2), device="cpu")
    state = ts.init_state(generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    o = state.opt_state
    for moments in (o.mu, o.nu, o.acc_grads):
        for n, t in moments.items():
            moments[n] = torch.rand(t.shape, generator=gen)
    tree = {"params": params_to_jax(state.params, CFG),
            "opt_state": {"mu": params_to_jax(o.mu, CFG), "nu": params_to_jax(o.nu, CFG),
                          "count": np.asarray(5, np.int32), "notfinite_count": np.asarray(2, np.int32),
                          "mini_step": np.asarray(1, np.int32), "acc_grads": params_to_jax(o.acc_grads, CFG)},
            "step": np.asarray(9, np.int64), "epoch": np.asarray(2, np.int64)}
    port_ckpt.save_tree(tmp_path / "old", tree, CFG)
    with np.load(tmp_path / "old" / "state.npz") as data:
        assert "['opt_state']['mu']['encoder']['emb']['embedding']" in data.files
    loaded, cfg = load_checkpoint(tmp_path / "old")
    params, got, step, epoch = port_ckpt.train_state_from_tree(loaded, cfg, "cpu")
    assert (step, epoch, int(got.count), int(got.notfinite_count), got.mini_step) == (9, 2, 5, 2, 1)
    for mine, theirs in ((got.mu, o.mu), (got.nu, o.nu), (got.acc_grads, o.acc_grads), (params, state.params)):
        assert all(torch.equal(mine[n], theirs[n].detach()) for n in theirs)


def test_pinned_keys_are_the_jax_trainer_s_and_the_port_s():
    pinned = json.loads(PINNED.read_text())["keys"]
    shape = jax.eval_shape(lambda: init_train_state(
        JaxMatchaConfig(), build_optimizer(JaxOptimizerConfig()), jax.random.PRNGKey(0)))
    jax_keys = sorted("['opt_state']" + jax.tree_util.keystr(p)
                      for p, _ in jax.tree_util.tree_flatten_with_path(shape.opt_state)[0])
    assert pinned == jax_keys
    cfg = MatchaConfig()
    with torch.device("meta"):
        names = MatchaTTS(cfg).state_dict()
    params = {n: torch.zeros(t.shape) for n, t in names.items()}
    tree = port_ckpt.optax_state_tree(AdamW(OptimizerConfig(), decay_mask(cfg)).init(params), cfg)
    assert sorted("['opt_state']" + k for k in flatten_keystr(tree)) == pinned
