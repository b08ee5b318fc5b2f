"""The port's multi-device paths against the JAX package's on a 2-device mesh.

The JAX package's data parallelism and serving fan-out both run one
program over a ``Mesh`` of devices (here two of the 8 virtual CPU devices
of ``tests/conftest.py``); the port's run one process per rank
(``torch.distributed`` over gloo) or one replica per device.  Same bridged
``init_params(tiny_config(), PRNGKey(0))`` weights on both sides.

  * Data parallelism: the batch of ``tests/test_torch_parallel.py`` (rows
    of unequal lengths, a repeat-filled row of weight 0, so the two ranks
    hold different frame counts), dropout off and CFM's (t, noise) fixed
    from numpy.  The JAX side is ``compute_losses`` under
    ``jax.value_and_grad`` jitted with the data-mesh step's shardings
    (parameters replicated, every batch leaf split on ``data``; the einsum
    attention and scan MAS that ``make_train_step(mesh=...)`` and the JAX
    trainer pick for a CPU mesh); the port side is world 2 over gloo, each
    rank on its block of rows, and the gradients compared are the ones its
    optimizer receives.  Tolerances as the single-process parity tests:
    each parameter's gradient within max|err| / max|ref| of 1e-4
    (``tests/test_torch_losses.py``), losses and the gradient norm 1e-5
    relative (``tests/test_torch_train_step.py``, which also holds the
    update that follows against optax).
  * Fan-out: ``MatchaSynthesizer(mesh=make_mesh(2 devices))`` against the
    port's ``MatchaSynthesizer(mesh=["cpu", "cpu"])``: a 3-request batch
    (padded to 4 rows, 2 a device) and one fused request (padded to one row
    a device).  Tolerance as ``tests/test_torch_inference.py``: waveform
    1e-3 of its peak.

The spawned workers import this module, so JAX is imported inside the
tests only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.parallel import mesh
from matcha_tpu_torch.train.step import TrainStep
from test_torch_parallel import OPT, WORLD, global_batch, rel_err, spawn

CFG = tiny_config()


def t_noise():
    """CFM's (t, noise) for the whole batch, from numpy."""
    batch = global_batch()
    rng = np.random.default_rng(21)
    t = rng.uniform(0.05, 0.95, (batch.x.shape[0], 1, 1)).astype(np.float32)
    return t, rng.standard_normal(tuple(batch.y.shape)).astype(np.float32)


def dp_worker(rank, init_file, out):
    """One port rank: its block of rows, its block of (t, noise)."""
    torch.set_num_threads(1)
    mesh.init_data_parallel("cpu", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    try:
        ts = TrainStep(CFG, OPT, device="cpu", data_parallel=True)
        seen = {}
        real = ts.opt.update

        def spy(params, grads, state):
            seen.update({n: g.detach().clone() for n, g in grads.items()})
            real(params, grads, state)

        ts.opt.update = spy
        state = ts.init_state(torch.load(f"{out}/params.pt"))
        rows = mesh.row_block(global_batch().x.shape[0], rank, WORLD)
        t, noise = (torch.from_numpy(a[rows]) for a in t_noise())
        state, metrics = ts.train_step(state, mesh.shard_rows(global_batch(), rank, WORLD), seed=0,
                                       deterministic=True, cfm_t_noise=(t, noise))
        torch.save({"grads": seen, "params": {n: p.detach() for n, p in state.params.items()},
                    "metrics": {k: float(v) for k, v in metrics.items()}}, f"{out}/rank{rank}.pt")
    finally:
        mesh.destroy()


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from matcha_tpu.models.config import tiny_config as jax_tiny_config
    from matcha_tpu.models.matcha import init_params

    init = jax.jit(lambda key: init_params(jax_tiny_config(), key))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def jax_mesh_grads(params):
    """Gradients, losses and gradient norm of the JAX model on the whole
    batch, jitted over a 2-device data mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from matcha_tpu.models.config import tiny_config as jax_tiny_config
    from matcha_tpu.models.matcha import MatchaTTS
    from matcha_tpu.parallel.mesh import batch_sharding, make_mesh, replicated, shard_batch

    data_mesh = make_mesh(jax.devices()[:WORLD])
    cfg = dataclasses.replace(jax_tiny_config(), attention_backend="einsum", mas_backend="scan")
    model = MatchaTTS(cfg)

    def loss_fn(p, batch, t, noise):
        out = model.apply({"params": p}, *batch[:7], jax.random.PRNGKey(0), deterministic=True,
                          cfm_t_noise=(t, noise), row_weights=batch[7], method=MatchaTTS.compute_losses)
        return out["loss"], out

    repl, data = replicated(data_mesh), batch_sharding(data_mesh)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                      in_shardings=(repl, data, data, data), out_shardings=repl)
    batch = shard_batch(data_mesh, tuple(t.numpy() for t in global_batch()))
    t, noise = shard_batch(data_mesh, t_noise())
    assert all(len(a.sharding.device_set) == WORLD for a in (*batch, t, noise))
    (_, losses), grads = grad_fn(jax.device_put(jax.tree.map(jnp.asarray, params), repl), batch, t, noise)
    return (jax.tree.map(np.asarray, grads), {k: float(v) for k, v in losses.items()},
            float(optax.global_norm(grads)))


def test_world2_step_matches_jax_data_mesh(tmp_path, jax_params):
    from matcha_tpu_torch.weights import params_from_jax

    torch.save(params_from_jax(jax_params, CFG), tmp_path / "params.pt")
    spawn(dp_worker, str(tmp_path / "store"), str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    grads, losses, grad_norm = jax_mesh_grads(jax_params)
    want = params_from_jax(grads, CFG)
    assert set(want) == set(ranks[0]["grads"])
    for name, g in want.items():
        assert rel_err(ranks[0]["grads"][name], g) <= 1e-4, name
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
    metrics = ranks[0]["metrics"]
    for port_key, jax_key in (("loss", "loss"), ("sub_loss/diff", "diff_loss"),
                              ("sub_loss/dur", "dur_loss"), ("sub_loss/prior", "prior_loss")):
        assert abs(metrics[port_key] - losses[jax_key]) <= 1e-5 * abs(losses[jax_key]), port_key
    assert abs(metrics["grad_norm"] - grad_norm) <= 1e-5 * grad_norm


WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
BUCKETS = dict(text_buckets=(16, 32), mel_fine_buckets=(64, 128, 256))


@pytest.fixture(scope="module")
def fanout_pair(jax_params):
    import jax

    from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer
    from matcha_tpu.models.config import tiny_config as jax_tiny_config
    from matcha_tpu.parallel.mesh import make_mesh
    from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
    from matcha_tpu.vocoder.vocos import init_vocos_params
    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.vocoder.vocos import VocosConfig
    from matcha_tpu_torch.weights import params_from_jax, vocos_params_from_jax

    vparams = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**WIDTHS)))
    ref = JaxSynthesizer(jax_tiny_config(), jax_params, vparams, JaxVocosConfig(**WIDTHS),
                         mesh=make_mesh(jax.devices()[:WORLD]), **BUCKETS)
    port = MatchaSynthesizer(CFG, params_from_jax(jax_params, CFG),
                             vocos_params_from_jax(vparams, VocosConfig(**WIDTHS)), VocosConfig(**WIDTHS),
                             mesh=["cpu"] * WORLD, **BUCKETS)
    return ref, port


def assert_wavs_match(port_rows, jax_rows):
    assert len(port_rows) == len(jax_rows)
    for p, r in zip(port_rows, jax_rows):
        assert p.wav.shape == r.wav.shape and len(p.wav) > 0
        np.testing.assert_allclose(p.wav, r.wav, atol=1e-3 * np.abs(r.wav).max())


def test_fanout_batch_matches_jax_mesh(fanout_pair):
    """3 requests pad to 4 rows on both sides: 2 a device."""
    ref, port = fanout_pair
    rng = np.random.default_rng(3)
    lists = [[int(i) for i in rng.integers(0, 600, n)] for n in (7, 12, 9)]
    assert port._pad_batch(3) == 4
    assert_wavs_match(port.synthesise_batch(lists, [0, 1, 2], n_timesteps=2, fused=True),
                      ref.synthesise_batch(lists, [0, 1, 2], n_timesteps=2, fused=True))


def test_fanout_request_matches_jax_mesh(fanout_pair):
    """One request pads to one row a device on both sides."""
    ref, port = fanout_pair
    ids = [int(i) for i in np.random.default_rng(4).integers(0, 600, 10)]
    assert_wavs_match([port.synthesise_ids(ids, speaker=1, n_timesteps=2, fused=True)],
                      [ref.synthesise_ids(ids, speaker=1, n_timesteps=2, fused=True)])
