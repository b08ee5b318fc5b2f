"""Tensor parallelism of the port against the JAX package's, on the CPU.

The JAX package splits the parameters over the ``model`` axis of a 2-D
``(data, model)`` mesh and lets GSPMD insert the collectives
(``matcha_tpu/parallel/sharding.py``); the port runs one process per rank
over gloo with explicit collectives (``matcha_tpu_torch/parallel/sharding.py``).

  * Specs: the port's split dimension of every parameter against the JAX
    ``tp_param_specs`` mapped through the weight bridge.  At
    ``tiny_config()`` (2 decoder and 2 encoder heads) and tp=2 they are
    equal; every difference elsewhere is one the port makes on purpose and
    is listed exactly: an attention pair whose heads do not split evenly
    stays whole (``MatchaConfig()``'s 5 decoder heads at tp=2, tiny's 2 at
    tp=16), and the Conformer's q, k, v biases split with their kernels.
  * Steps: world 2 (dp1 × tp2) and world 4 (dp2 × tp2) over gloo, one
    ``TrainStep`` each, dropout 0 and CFM's (t, noise) fixed from numpy, on
    the batch of ``tests/test_torch_parallel.py`` (ragged rows, a
    repeat-filled row of weight 0), from bridged
    ``init_params(tiny_config(), PRNGKey(0))`` weights; held against the
    JAX step computed on ``make_mesh_2d(jax.devices()[:4], dp=2, tp=2)``
    with the split shardings, and on one device: losses 1e-4 and the
    parameters after the AdamW update (lr 1e-3, eps 1e-3 on both sides)
    2e-5, as ``tests/test_tensor_parallel.py`` holds JAX to JAX.
  * Dropout on (world 2, encoder 0.1, decoder 0.3): each rank's mask on
    its block of channels is that block of the full mask a single process
    draws from the same (seed, step, data index), so the step equals the
    single process's (losses 1e-5 relative, parameters 1e-5).
  * A ``Trainer(tensor_parallel=2)`` trains 2 steps as one process does;
    its checkpoint (whole tensors, written by rank 0) resumes at tp=1
    bit-equal and converts to the JAX tree; a row-parallel layer's bias is
    added once; a Conformer decoder trains split as whole.

One spawn per world serves all its assertions (module fixtures).  The
spawned workers import this module, so JAX is imported inside the tests
only.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from matcha_tpu_torch.models.config import MatchaConfig, tiny_config
from matcha_tpu_torch.models.layers import Linear, dropout
from matcha_tpu_torch.models.matcha import MatchaTTS, init_params
from matcha_tpu_torch.parallel import mesh, sharding
from matcha_tpu_torch.train.step import TrainStep
from test_torch_parallel import CFG, OPT, global_batch, make_trainer, rel_err, write_corpus

TP = 2
DROPOUT_CFG = dataclasses.replace(tiny_config(), decoder=dataclasses.replace(tiny_config().decoder, dropout=0.3))
CONFORMER_CFG = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, block_type="conformer"))


def t_noise():
    """CFM's (t, noise) for the whole batch, from numpy."""
    batch = global_batch()
    rng = np.random.default_rng(21)
    t = rng.uniform(0.05, 0.95, (batch.x.shape[0], 1, 1)).astype(np.float32)
    return t, rng.standard_normal(tuple(batch.y.shape)).astype(np.float32)


def step_record(ts: TrainStep, params, batch, fixed_rows=None, seed=0):
    """One step from whole ``params``: whole parameters after it, metrics.
    ``fixed_rows``: the rows of the fixed (t, noise) this process holds
    (dropout off); None draws them, with dropout on."""
    state = ts.init_state(params)
    kwargs = {}
    if fixed_rows is not None:
        t, noise = (torch.from_numpy(a[fixed_rows]) for a in t_noise())
        kwargs = {"deterministic": True, "cfm_t_noise": (t, noise)}
    state, metrics = ts.train_step(state, batch, seed=seed, **kwargs)
    whole, _ = ts.whole_state(state)
    return {"params": {n: p.detach().clone() for n, p in whole.items()},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def tp_worker(rank, world, store, out):
    import sys

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    mesh.init_data_parallel("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        grid = sharding.make_mesh_2d(world, TP)
        res = {"d": grid.d, "m": grid.m}
        params = torch.load(f"{out}/params.pt")
        rows = mesh.row_block(global_batch().x.shape[0], grid.d, grid.dp)
        batch = mesh.shard_rows(global_batch(), grid.d, grid.dp)
        ts = TrainStep(CFG, OPT, device="cpu", mesh2d=grid)
        res["local_shapes"] = {n: tuple(p.shape) for n, p in ts.init_state(params).params.items()}
        res["fixed"] = step_record(ts, params, batch, fixed_rows=rows)
        if world == 2:
            res.update(world2_checks(grid, batch, out))
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        mesh.destroy()


def world2_checks(grid, batch, out) -> dict:
    res = {}
    # dropout on: the single process's masks, block by block
    drop_params = init_params(DROPOUT_CFG, torch.Generator().manual_seed(0))
    res["dropout"] = step_record(TrainStep(DROPOUT_CFG, OPT, device="cpu", mesh2d=grid), drop_params, batch, seed=7)
    x = torch.randn((3, 5, 8), generator=torch.Generator().manual_seed(1))
    block = x.narrow(-1, 4 * grid.m, 4)
    gen = torch.Generator().manual_seed(2)
    res["mask_block"] = dropout(block, 0.5, gen, (-1, grid.m, TP))
    res["generator_after"] = gen.get_state()
    # a row-parallel layer: partial products summed, the bias added once
    lin = Linear(8, 3)
    with torch.no_grad():
        lin.bias.copy_(torch.tensor([1.0, 2.0, 3.0]))
        lin.weight.copy_(torch.arange(24.0).reshape(3, 8) / 10)
    lin.weight.data = lin.weight.data[:, 4 * grid.m: 4 * grid.m + 4]
    lin.row_parallel = sharding.TPGroup(grid.tp_group, TP, grid.m)
    res["row_zero"] = lin(torch.zeros((2, 4)))
    res["row_ones"] = lin(torch.ones((2, 4)))
    # the Conformer decoder, split
    res["conformer"] = step_record(TrainStep(CONFORMER_CFG, OPT, device="cpu", mesh2d=grid),
                                   init_params(CONFORMER_CFG, torch.Generator().manual_seed(0)), batch,
                                   fixed_rows=slice(None))
    # the Trainer, two steps, and its checkpoint
    with make_trainer(Path(out), tensor_parallel=TP) as trainer:
        state = trainer.fit(max_steps=2)
        whole, opt = trainer.steps.whole_state(state)
        res["trainer"] = {"mesh": (trainer.mesh2d.dp, trainer.mesh2d.tp),
                          "multiple": trainer.sampler.batch_multiple,
                          "params": {n: p.detach().clone() for n, p in whole.items()},
                          "mu": {n: t.clone() for n, t in opt.mu.items()},
                          "local": tuple(state.params["decoder.estimator.mid_blocks.0.1.0.ff.net.0.proj.weight"].shape)}
    return res


def spawn(world, tmp_path, params):
    torch.save(params, tmp_path / "params.pt")
    mp.start_processes(tp_worker, args=(world, str(tmp_path / "store"), str(tmp_path)), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from matcha_tpu.models.config import tiny_config as jax_tiny_config
    from matcha_tpu.models.matcha import init_params as jax_init_params

    init = jax.jit(lambda key: jax_init_params(jax_tiny_config(), key))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def jax_tp_step(params, tp_mesh: bool):
    """The JAX step on the whole batch at dropout 0 with the fixed (t,
    noise): losses and the parameters after the AdamW update; with
    ``tp_mesh`` jitted on a (data 2, model 2) mesh, parameters split by
    ``tp_param_specs``, the batch on ``data``."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from matcha_tpu.models.config import tiny_config as jax_tiny_config
    from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
    from matcha_tpu.parallel.sharding import make_mesh_2d, tp_param_specs
    from matcha_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from matcha_tpu.train.optim import build_optimizer

    cfg = dataclasses.replace(jax_tiny_config(), attention_backend="einsum", mas_backend="scan")
    model = JaxMatchaTTS(cfg)
    tx = build_optimizer(JaxOptimizerConfig(lr=OPT.lr, eps=OPT.eps))

    def step(p, batch, t, noise):
        def loss_fn(p):
            out = model.apply({"params": p}, *batch[:7], jax.random.PRNGKey(0), deterministic=True,
                              cfm_t_noise=(t, noise), row_weights=batch[7],
                              method=JaxMatchaTTS.compute_losses)
            return out["loss"], out

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return losses, optax.apply_updates(p, updates)

    batch = tuple(jnp.asarray(t.numpy()) for t in global_batch())
    t, noise = map(jnp.asarray, t_noise())
    p = jax.tree.map(jnp.asarray, params)
    if not tp_mesh:
        losses, new = jax.jit(step)(p, batch, t, noise)
    else:
        grid = make_mesh_2d(jax.devices()[:4], dp=2, tp=TP)
        p_sh = jax.tree.map(lambda s: NamedSharding(grid, s), tp_param_specs(p, TP))
        data, repl = NamedSharding(grid, P("data")), NamedSharding(grid, P())
        p = jax.device_put(p, p_sh)
        batch, t, noise = jax.device_put((batch, t, noise), data)
        losses, new = jax.jit(step, in_shardings=(p_sh, data, data, data),
                              out_shardings=(repl, p_sh))(p, batch, t, noise)
        kern = new["decoder"]["mid0_tblock0"]["ff"]["proj_in"]["kernel"]
        assert kern.addressable_shards[0].data.shape[-1] * TP == kern.shape[-1]
    return {k: float(v) for k, v in losses.items()}, jax.tree.map(np.asarray, new)


@pytest.fixture(scope="module")
def jax_steps(jax_params):
    return {"tp": jax_tp_step(jax_params, True), "single": jax_tp_step(jax_params, False)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_params):
    from matcha_tpu_torch.weights import params_from_jax

    root = tmp_path_factory.mktemp("tp_world2")
    write_corpus(root)
    return spawn(2, root, params_from_jax(jax_params, CFG)), root


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_params):
    from matcha_tpu_torch.weights import params_from_jax

    return spawn(4, tmp_path_factory.mktemp("tp_world4"), params_from_jax(jax_params, CFG))


# -- specs ----------------------------------------------------------------------

def spec_differences(jax_cfg, port_cfg, tp) -> dict[str, tuple]:
    """{port name: (JAX's torch dim, the port's)} wherever they differ."""
    import jax

    from matcha_tpu.models.matcha import init_params as jax_init_params
    from matcha_tpu.parallel.sharding import MODEL_AXIS
    from matcha_tpu.parallel.sharding import tp_param_specs as jax_tp_param_specs
    from matcha_tpu_torch.weights import flatten_tree, matcha_param_table

    shapes = jax.eval_shape(lambda k: jax_init_params(jax_cfg, k), jax.random.PRNGKey(0))
    jax_specs = flatten_tree(jax_tp_param_specs(shapes, tp))
    ours = sharding.tp_param_specs(MatchaTTS(port_cfg).state_dict(), port_cfg, tp)
    diff = {}
    for name, path, kind in matcha_param_table(port_cfg):
        spec = tuple(jax_specs[path])
        want = sharding._TORCH_DIM[kind][spec.index(MODEL_AXIS)] if MODEL_AXIS in spec else None
        if want != ours[name]:
            diff[name] = (want, ours[name])
    return diff


def decoder_attention(cfg, suffixes) -> set[str]:
    names = MatchaTTS(cfg).state_dict()
    return {n for n in names if n.startswith("decoder.") and n.endswith(suffixes)}


def test_specs_equal_jax_at_tiny_config():
    from matcha_tpu.models.config import tiny_config as jax_tiny_config

    assert spec_differences(jax_tiny_config(), tiny_config(), TP) == {}
    specs = sharding.tp_param_specs(MatchaTTS(CFG).state_dict(), CFG, TP)
    tb = "decoder.estimator.mid_blocks.0.1.0"
    assert specs[f"{tb}.ff.net.0.proj.weight"] == 0 and specs[f"{tb}.ff.net.0.proj.bias"] == 0
    assert specs[f"{tb}.ff.net.0.alpha"] == 0 and specs[f"{tb}.ff.net.2.weight"] == 1
    assert specs[f"{tb}.ff.net.2.bias"] is None
    assert specs[f"{tb}.attn1.to_q.weight"] == 0 and specs[f"{tb}.attn1.to_out.0.weight"] == 1
    assert specs["encoder.encoder.ffn_layers.0.conv_1.weight"] == 0
    assert specs["encoder.encoder.ffn_layers.0.conv_2.weight"] == 1
    assert specs["encoder.encoder.attn_layers.1.conv_q.bias"] == 0
    assert specs["encoder.emb.weight"] is None


@pytest.mark.parametrize("case", ["default_5_heads_tp2", "tiny_tp16", "conformer_tp2"])
def test_spec_differences_are_the_deliberate_ones(case):
    """Every leaf where the port's spec differs from the JAX one, and why."""
    from matcha_tpu.models.config import DecoderConfig as JaxDecoderConfig
    from matcha_tpu.models.config import MatchaConfig as JaxMatchaConfig
    from matcha_tpu.models.config import tiny_config as jax_tiny_config

    if case == "default_5_heads_tp2":
        # 5 heads of 64 do not split in 2: the port keeps each decoder
        # attention pair whole, JAX splits its 320 channels mid-head
        diff = spec_differences(JaxMatchaConfig(), MatchaConfig(), 2)
        want = decoder_attention(MatchaConfig(), (".to_q.weight", ".to_k.weight", ".to_v.weight",
                                                  ".to_out.0.weight"))
        assert all(ours is None for _, ours in diff.values())
    elif case == "tiny_tp16":
        # 2 heads over 16 ranks: whole pairs replicated; the 16 channels split
        diff = spec_differences(jax_tiny_config(), tiny_config(), 16)
        want = decoder_attention(tiny_config(), (".to_q.weight", ".to_k.weight", ".to_v.weight",
                                                 ".to_out.0.weight"))
        assert all(ours is None for _, ours in diff.values())
    else:
        # the Conformer's q, k, v biases split with their column-parallel kernels
        jcfg = dataclasses.replace(jax_tiny_config(), decoder=dataclasses.replace(
            jax_tiny_config().decoder, block_type="conformer"))
        assert isinstance(jcfg.decoder, JaxDecoderConfig)
        diff = spec_differences(jcfg, CONFORMER_CFG, TP)
        want = decoder_attention(CONFORMER_CFG, (".to_q.bias", ".to_k.bias", ".to_v.bias"))
        assert all(d == (None, 0) for d in diff.values())
    assert set(diff) == want and want


def test_grid_needs_tp_to_divide_the_world():
    with pytest.raises(ValueError, match="does not divide"):
        sharding.make_mesh_2d(3, 2)
    with pytest.raises(ValueError, match="tp must be"):
        sharding.tp_param_specs(MatchaTTS(CFG).state_dict(), CFG, 0)


def test_shard_and_gather_roundtrip_locally():
    whole = init_params(CFG, torch.Generator().manual_seed(0))
    specs = sharding.tp_param_specs(whole, CFG, TP)
    blocks = [sharding.shard_state(whole, specs, TP, m) for m in range(TP)]
    for name, t in whole.items():
        dim = specs[name]
        got = t if dim is None else torch.cat([b[name] for b in blocks], dim=dim)
        assert torch.equal(got, t), name


# -- the steps ------------------------------------------------------------------

def assert_step_matches_jax(ranks, jax_steps):
    from matcha_tpu_torch.weights import params_from_jax

    for ref_losses, ref_params in jax_steps.values():
        want = params_from_jax(ref_params, CFG)
        for r in ranks:
            metrics, params = r["fixed"]["metrics"], r["fixed"]["params"]
            for port_key, jax_key in (("loss", "loss"), ("sub_loss/diff", "diff_loss"),
                                      ("sub_loss/dur", "dur_loss"), ("sub_loss/prior", "prior_loss")):
                assert abs(metrics[port_key] - ref_losses[jax_key]) <= 1e-4, port_key
            assert set(params) == set(want)
            for name, p in want.items():
                torch.testing.assert_close(params[name], p, rtol=0, atol=2e-5, msg=name)


def test_world2_step_matches_jax_tp_mesh(world2, jax_steps):
    ranks, _ = world2
    assert [(r["d"], r["m"]) for r in ranks] == [(0, 0), (0, 1)]
    # parameters are really split: a column-parallel block is half its kernel
    name = "decoder.estimator.mid_blocks.0.1.0.ff.net.0.proj.weight"
    assert ranks[0]["local_shapes"][name][0] * TP == MatchaTTS(CFG).state_dict()[name].shape[0]
    assert_step_matches_jax(ranks, jax_steps)
    for name, p in ranks[0]["fixed"]["params"].items():
        assert torch.equal(p, ranks[1]["fixed"]["params"][name]), name


def test_world4_step_matches_jax_tp_mesh(world4, jax_steps):
    assert [(r["d"], r["m"]) for r in world4] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert_step_matches_jax(world4, jax_steps)
    assert len({r["fixed"]["metrics"]["grad_norm"] for r in world4}) == 1


def test_dropout_masks_are_blocks_of_the_single_process_mask(world2):
    ranks, _ = world2
    x = torch.randn((3, 5, 8), generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    full = dropout(x, 0.5, gen)
    assert torch.equal(torch.cat([r["mask_block"] for r in ranks], dim=-1), full)
    assert all(torch.equal(r["generator_after"], gen.get_state()) for r in ranks)
    # through the whole model: the tp=2 step with dropout on is the single
    # process's step at the same (seed, step, data index 0)
    ts = TrainStep(DROPOUT_CFG, OPT, device="cpu")
    single = step_record(ts, init_params(DROPOUT_CFG, torch.Generator().manual_seed(0)), global_batch(), seed=7)
    for r in ranks:
        for k in ("loss", "sub_loss/diff", "sub_loss/dur", "sub_loss/prior", "grad_norm"):
            assert abs(r["dropout"]["metrics"][k] - single["metrics"][k]) <= 1e-5 * abs(single["metrics"][k]), k
        for name, p in single["params"].items():
            torch.testing.assert_close(r["dropout"]["params"][name], p, rtol=0, atol=1e-5, msg=name)


def test_row_parallel_bias_is_added_once(world2):
    ranks, _ = world2
    bias = torch.tensor([1.0, 2.0, 3.0])
    weight = torch.arange(24.0).reshape(3, 8) / 10
    for r in ranks:
        assert torch.equal(r["row_zero"], bias.expand(2, 3))
        torch.testing.assert_close(r["row_ones"], (weight.sum(dim=1) + bias).expand(2, 3))


def test_conformer_decoder_splits_as_whole(world2):
    ranks, _ = world2
    ts = TrainStep(CONFORMER_CFG, OPT, device="cpu")
    single = step_record(ts, init_params(CONFORMER_CFG, torch.Generator().manual_seed(0)), global_batch(),
                         fixed_rows=slice(None))
    for r in ranks:
        assert abs(r["conformer"]["metrics"]["loss"] - single["metrics"]["loss"]) <= 1e-5 * single["metrics"]["loss"]
        for name, p in single["params"].items():
            torch.testing.assert_close(r["conformer"]["params"][name], p, rtol=0, atol=1e-5, msg=name)


def test_trainer_tp2_trains_as_one_process(world2, tmp_path, monkeypatch):
    import sys

    ranks, root = world2
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert all(r["trainer"]["mesh"] == (1, TP) and r["trainer"]["multiple"] == 1 for r in ranks)
    (tmp_path / "train.csv").symlink_to(root / "train.csv")
    (tmp_path / "mels").symlink_to(root / "mels")
    with make_trainer(tmp_path) as trainer:
        state = trainer.fit(max_steps=2)
    tp_losses = [json.loads(line).get("loss") for line in open(root / "run" / "metrics.jsonl")]
    one_losses = [json.loads(line).get("loss") for line in open(tmp_path / "run" / "metrics.jsonl")]
    np.testing.assert_allclose([v for v in tp_losses if v is not None], [v for v in one_losses if v is not None],
                               rtol=1e-5)
    for name, p in state.params.items():
        torch.testing.assert_close(ranks[0]["trainer"]["params"][name], p.detach(), rtol=0, atol=1e-5, msg=name)
    name = "decoder.estimator.mid_blocks.0.1.0.ff.net.0.proj.weight"
    assert ranks[0]["trainer"]["local"][0] * TP == state.params[name].shape[0]


def test_tp2_checkpoint_resumes_at_tp1(world2, tmp_path):
    from matcha_tpu_torch.checkpoint import load_checkpoint
    from matcha_tpu_torch.train.checkpoint import train_state_from_tree
    from matcha_tpu_torch.weights import params_to_jax

    ranks, root = world2
    (ckpt,) = sorted((root / "run" / "checkpoints").glob("epoch_*"))
    tree, cfg = load_checkpoint(ckpt)
    assert cfg == CFG
    params, opt_state, step, _ = train_state_from_tree(tree, cfg, "cpu")
    assert step == 2
    for name, p in params.items():
        assert torch.equal(p.detach(), ranks[0]["trainer"]["params"][name]), name
        assert torch.equal(opt_state.mu[name], ranks[0]["trainer"]["mu"][name]), name
    # at tp=1 it takes a step, and it is the JAX trainer's tree
    ts = TrainStep(CFG, OPT, device="cpu")
    state = ts.init_state(params)
    state.opt_state = opt_state
    state.step = step
    _, metrics = ts.train_step(state, global_batch(), seed=1)
    assert np.isfinite(float(metrics["loss"]))
    assert set(params_to_jax(params, cfg)) == {"speaker_embeddings_enc", "speaker_embeddings_dur", "encoder",
                                               "decoder"}
