"""The multi-tensor AdamW's tables, wrapper checks and returned norm, on the CPU.

The kernels themselves (``ops/csrc/adamw.cu``) run only on a card
(``chip_smoke.py`` phase ``adamw`` holds them against the loop); here: the
chunk table the kernels walk covers every element of every parameter once,
its flags follow the weight-decay and trainable masks, the wrapper refuses
what the kernels cannot take (it never falls back to the loop), and
``AdamW.update`` returns the norm the clip read, which ``train_step``
reports as ``grad_norm``; the training state, fresh or resumed, is
contiguous, as the kernels take it.
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.finetune_speaker import trainable_mask_for_speaker
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import init_params
from matcha_tpu_torch.ops import adamw
from matcha_tpu_torch.train.checkpoint import optax_state_tree, train_state_from_tree
from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig, global_norm
from matcha_tpu_torch.train.step import Batch, TrainStep
from matcha_tpu_torch.weights import decay_mask, params_from_jax, params_to_jax

CFG = tiny_config()


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0))


def _grads(params, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=gen) * scale for n, p in params.items()}


@pytest.mark.parametrize("chunk", [4, 8, adamw.CHUNK])
@pytest.mark.parametrize("numels", [
    [1], [1, 2, 3, 4, 5, 6, 7, 8, 9], [0, 5, 0],
    [adamw.CHUNK - 1, adamw.CHUNK, adamw.CHUNK + 1, 3 * adamw.CHUNK + 7, 1],
])
def test_chunk_table_covers_every_element_once(numels, chunk):
    flags = [i % 4 for i in range(len(numels))]
    table = adamw.chunk_table(numels, flags, chunk)
    assert table.dtype == np.int64 and table.shape[1] == 4
    hits = [np.zeros(n, np.int64) for n in numels]
    for leaf, start, count, f in table:
        assert 1 <= count <= chunk and start % chunk == 0 and start + count <= numels[leaf]
        assert f == flags[leaf]
        hits[leaf][start:start + count] += 1
    assert all((h == 1).all() for h in hits)
    assert table.shape[0] == sum(-(-n // chunk) for n in numels)
    assert (np.diff(table[:, 0]) >= 0).all()  # in the parameters' order


@pytest.mark.parametrize("trainable", [None, "speaker"])
def test_flags_follow_the_masks(params, trainable):
    mask = None if trainable is None else trainable_mask_for_speaker(CFG)
    decay = decay_mask(CFG)
    opt = AdamW(OptimizerConfig(), decay, mask)
    state = opt.init(params)
    with pytest.raises(ValueError, match="CUDA"):  # the CPU's leaves: the table is built, nothing launched
        opt.fused.step(params, _grads(params, 0), state, opt.cfg, 10)
    names = list(params)
    table = opt.fused._chunks.numpy()
    for leaf, n in enumerate(names):
        flags = set(table[table[:, 0] == leaf, 3].tolist())
        want = (adamw.DECAY if decay[n] else 0) | (adamw.TRAINABLE if mask is None or mask[n] else 0)
        assert flags == {want}, n
    assert adamw.leaf_flags(names, decay, mask) == [
        (adamw.DECAY if decay[n] else 0) | (adamw.TRAINABLE if mask is None or mask[n] else 0) for n in names]
    assert len({f & adamw.DECAY for f in adamw.leaf_flags(names, decay, mask)}) == 2
    if mask is not None:
        assert sum(f & adamw.TRAINABLE != 0 for f in adamw.leaf_flags(names, decay, mask)) == 2


def _opt_state(params):
    opt = AdamW(OptimizerConfig(), decay_mask(CFG))
    return opt, opt.init(params)


@pytest.mark.parametrize("what", ["cpu", "grad_strided", "param_strided", "grad_bf16", "grad_size"])
def test_wrapper_refuses_what_the_kernels_cannot_take(params, what):
    params = {n: p.clone() for n, p in params.items()}
    grads = _grads(params, 0)
    opt, state = _opt_state(params)
    first = next(iter(params))
    shape = params[first].shape
    match = {"cpu": "CUDA", "grad_bf16": "float32", "grad_size": "elements"}.get(what, "contiguous")
    if what == "grad_strided":
        grads[first] = torch.zeros(2 * params[first].numel())[::2].view(shape)
    elif what == "param_strided":
        params[first] = torch.zeros(2 * params[first].numel())[::2].view(shape)
    elif what == "grad_bf16":
        grads[first] = grads[first].bfloat16()
    elif what == "grad_size":
        grads[first] = torch.zeros(params[first].numel() + 1)
    before = {n: p.clone() for n, p in params.items()}
    with pytest.raises(ValueError, match=match):
        opt.fused.step(params, grads, state, opt.cfg, 10)
    assert all(torch.equal(params[n], before[n]) for n in params)
    assert int(state.count) == 0


def test_update_returns_the_clip_norm(params):
    params = {n: p.clone() for n, p in params.items()}
    opt, state = _opt_state(params)
    for seed, scale in ((0, 1.0), (1, 1e-3)):  # clipped, not clipped
        grads = _grads(params, seed, scale)
        norm = opt.update(params, grads, state)
        assert torch.equal(norm, global_norm(grads.values()))


def test_update_returns_none_under_accumulation(params):
    params = {n: p.clone() for n, p in params.items()}
    opt = AdamW(OptimizerConfig(accumulate_grad_batches=2), decay_mask(CFG))
    state = opt.init(params)
    before = {n: p.clone() for n, p in params.items()}
    for i in range(4):
        assert opt.update(params, _grads(params, i), state) is None
        moved = any(not torch.equal(params[n], before[n]) for n in params)
        assert moved == (i >= 1)
    assert int(state.count) == 2


def _batch():
    rng = np.random.default_rng(0)
    b, tx, ty = 3, 10, 12
    y_len = rng.integers(8, ty + 1, (b,))
    arrays = (rng.integers(0, 600, (b, tx)), rng.integers(4, tx + 1, (b,)),
              rng.standard_normal((b, ty, CFG.n_feats)).astype(np.float32), y_len,
              rng.standard_normal((b, 2 * ty, CFG.n_feats)).astype(np.float32), 2 * y_len,
              rng.integers(0, CFG.n_spks, (b,)))
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in arrays))


@pytest.mark.parametrize("update", ["applied", "no_op"])
def test_train_step_grad_norm_is_the_gradients_norm(params, update):
    ts = TrainStep(CFG, OptimizerConfig(lr=1e-3), device="cpu")
    state = ts.init_state(params)
    seen = []
    grads_of = ts._grads

    def grads(loss, p):
        seen.append(grads_of(loss, p))
        return seen[-1]

    ts._grads = grads
    if update == "no_op":
        ts.opt.update = lambda params, grads, state: None
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = ts.train_step(state, _batch(), seed=0, deterministic=True)
    assert torch.equal(metrics["grad_norm"], global_norm(seen[0].values()))
    moved = any(not torch.equal(state.params[n], before[n]) for n in before)
    assert moved == (update == "applied")


@pytest.mark.parametrize("source", ["state_dict", "checkpoint"])
def test_training_state_is_contiguous(params, source):
    # a bridged state_dict (a checkpoint's weights) holds transposed views
    tree = params_to_jax(params, CFG)
    bridged = params_from_jax(tree, CFG)
    assert not all(t.is_contiguous() for t in bridged.values())
    ts = TrainStep(CFG, OptimizerConfig(), device="cpu")
    state = ts.init_state(bridged)
    p, opt_state = state.params, state.opt_state
    if source == "checkpoint":
        p, opt_state, _, _ = train_state_from_tree(
            {"params": tree, "opt_state": optax_state_tree(opt_state, CFG)}, CFG, "cpu")
    for leaves in (p, opt_state.mu, opt_state.nu):
        assert all(t.is_contiguous() for t in leaves.values())
    with pytest.raises(ValueError, match="CUDA"):  # every check but the device's passes
        ts.opt.fused.step(p, _grads(p, 0), opt_state, ts.opt.cfg, 10)
