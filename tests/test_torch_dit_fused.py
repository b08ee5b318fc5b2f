"""The DiT's fused glue (``ops/dit_fused.py``) on the CPU: each op's
autograd Function, which runs the plain version of its kernel's contract on
a CPU tensor (forward and the hand-written backward), against autograd of
its formula written out here or in the plain reference
``tests/plain_f5tts.py``; the dropout masks against ``layers.dropout``'s;
the bits; and the whole ``F5TTS`` step, which calls the four ops on every
device, against the plain reference's step on the same draws and masks,
and the DiT's output on padded rows too.  The kernels themselves
(``ops/csrc/dit_fused.cu``) run only on a card: ``chip_smoke.py`` phase
``dit_fused`` holds them against these plain versions there.

Tolerances, fp32 throughout: 1e-5 of the largest element for values and
gradients (the LayerNorm's statistics and the column sums are summed in
another order than autograd's; everything else is the same fp32 arithmetic,
exact in practice); the whole step at ``test_torch_f5tts.py``'s one-step
tolerance, the loss 1e-5 relative and every leaf's gradient 1e-5 of its
largest element (or of the median leaf's where a leaf is smaller).  RoPE's
forward and the masks are held bit for bit.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

import plain_f5tts as ref
from matcha_tpu_torch.models import dit
from matcha_tpu_torch.models.config import tiny_dit_config
from matcha_tpu_torch.models.layers import dropout
from matcha_tpu_torch.ops import dit_fused
from matcha_tpu_torch.utils.model_math import sequence_mask

P = dit.DROPOUT
SHAPES = [(1, 9), (3, 17), (2, 24)]  # (B, N): B = 1, odd N, an even one
WIDTH = 64


def close(got, want, tol=1e-5):
    got, want = got.detach().float(), want.detach().float()
    assert float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1e-30)


def vectors(b, width, seed, chunks=6):
    """A (B, 1, chunks·C) adaLN output chunked as the blocks chunk it:
    views with batch stride chunks·C, requiring grad."""
    base = torch.randn((b, 1, chunks * width), generator=torch.Generator().manual_seed(seed)) * 0.5
    base.requires_grad_()
    return base, base.chunk(chunks, dim=-1)


def ragged_keep(b, n, seed):
    """(B, N) bool: ragged lengths, the last row full, one row padded to a
    single frame when B > 2."""
    lengths = torch.randint(1, n + 1, (b,), generator=torch.Generator().manual_seed(seed))
    lengths[-1] = n
    if b > 2:
        lengths[0] = 1
    return sequence_mask(lengths, n)


def grads_of(out, inputs, dout):
    return torch.autograd.grad(out, inputs, dout)


def modulate_formula(h, scale, shift):
    """LN₀(h)·(1 + scale) + shift in fp32, by autograd."""
    return F.layer_norm(h, (h.shape[-1],), eps=dit.LN_EPS) * (1.0 + scale) + shift


def rope_formula(x, heads):
    """(B, N, H·D) → (B, H, N, D) in x's dtype: each head rotated in fp32 as
    the plain reference rotates it (x-transformers' interleaved pairs)."""
    b, n, inner = x.shape
    xh = x.float().reshape(b, n, heads, -1).transpose(1, 2)
    freqs = ref.rotary(n, inner // heads, x.device)
    return (xh * freqs.cos() + ref.rotate_half(xh) * freqs.sin()).to(x.dtype).contiguous()


@pytest.mark.parametrize("b,n", SHAPES)
def test_modulate_matches_the_eager_expression(b, n):
    gen = torch.Generator().manual_seed(b * 100 + n)
    h = (torch.randn((b, n, WIDTH), generator=gen) * 3 + 1.5).requires_grad_()
    base, (shift, scale, *_) = vectors(b, WIDTH, n)
    dy = torch.randn((b, n, WIDTH), generator=gen)
    want = modulate_formula(h, scale, shift)
    got = dit_fused.modulate(h, scale, shift, torch.float32, dit.LN_EPS, "attn")
    close(got, want)
    for g, w in zip(grads_of(got, (h, base), dy), grads_of(want, (h, base), dy)):
        close(g, w)


def test_modulate_rounds_once_to_the_products_dtype():
    gen = torch.Generator().manual_seed(7)
    h = torch.randn((2, 11, WIDTH), generator=gen)
    _, (shift, scale, *_) = vectors(2, WIDTH, 3)
    want = modulate_formula(h, scale, shift).to(torch.bfloat16)
    got = dit_fused.modulate(h, scale, shift, torch.bfloat16, dit.LN_EPS)
    assert got.dtype == torch.bfloat16
    close(got, want, 2**-7)


def test_modulate_saves_the_row_statistics():
    gen = torch.Generator().manual_seed(8)
    h = torch.randn((2, 5, WIDTH), generator=gen) * 2 - 1
    _, (shift, scale, *_) = vectors(2, WIDTH, 4)
    _, mean, rstd = dit_fused.modulate_fwd_plain(h, scale, shift, torch.float32, dit.LN_EPS)
    _, want_mean, want_rstd = torch.ops.aten.native_layer_norm(h, (WIDTH,), None, None, dit.LN_EPS)
    close(mean, want_mean[..., 0])
    close(rstd, want_rstd[..., 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n", SHAPES)
def test_rope_heads_match_the_eager_layout(b, n, dtype):
    heads, dim_head = 4, 16
    gen = torch.Generator().manual_seed(n)
    rope = dit._table("rope", dim_head, n, "cpu")
    q, k, v = (torch.randn((b, n, heads * dim_head), generator=gen).to(dtype).requires_grad_() for _ in range(3))
    want = (rope_formula(q, heads), rope_formula(k, heads), v.reshape(b, n, heads, -1).transpose(1, 2).contiguous())
    got = dit_fused.rope_heads(q, k, v, rope, heads)
    for g, w in zip(got, want):
        assert g.shape == (b, heads, n, dim_head) and g.is_contiguous() and g.dtype == dtype
        assert torch.equal(g, w)
    douts = [torch.randn(w.shape, generator=gen).to(dtype) for w in want]
    got_grads = torch.autograd.grad(got, (q, k, v), douts)
    want_grads = torch.autograd.grad(want, (q, k, v), douts)
    for g, w in zip(got_grads, want_grads):
        assert g.dtype == dtype
        close(g, w, 1e-5 if dtype == torch.float32 else 2**-7)


def eager_attention_branch(h, g, y, keep, gen):
    return h + g * dropout(y, P, gen).masked_fill(~keep[..., None], 0.0)


@pytest.mark.parametrize("branch", ["attn-dropout", "attn-deterministic", "ff"])
@pytest.mark.parametrize("b,n", SHAPES)
def test_gated_residual_matches_the_eager_expression(b, n, branch):
    seed = b * 1000 + n
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn((b, n, WIDTH), generator=gen).requires_grad_()
    y = torch.randn((b, n, WIDTH), generator=gen).requires_grad_()
    base, (_, _, gate, *_) = vectors(b, WIDTH, seed)
    dout = torch.randn((b, n, WIDTH), generator=gen)
    keep = ragged_keep(b, n, seed)
    if branch == "ff":
        want = h + gate * y
        got = dit_fused.gated_residual(h, gate, y, 0.0, None, None, "ff")
    else:
        drop = branch == "attn-dropout"
        want = eager_attention_branch(h, gate, y, keep, torch.Generator().manual_seed(5) if drop else None)
        got = dit_fused.gated_residual(h, gate, y, P, torch.Generator().manual_seed(5) if drop else None,
                                       keep, "attn")
    close(got, want)
    for g, w in zip(grads_of(got, (h, y, base), dout), grads_of(want, (h, y, base), dout)):
        close(g, w)


def test_gated_residual_zeroes_padded_rows_and_their_gradients():
    b, n = 3, 10
    keep = ragged_keep(b, n, 1)
    h = torch.randn((b, n, WIDTH))
    y = torch.randn((b, n, WIDTH), requires_grad=True)
    _, (_, _, gate, *_) = vectors(b, WIDTH, 2)
    out = dit_fused.gated_residual(h, gate, y, P, torch.Generator().manual_seed(1), keep, "attn")
    assert torch.equal(out[~keep], h[~keep])
    (dy,) = torch.autograd.grad(out, y, torch.ones_like(out))
    assert not dy[~keep].any() and dy[keep].any()


@pytest.mark.parametrize("drop", [True, False], ids=["dropout", "deterministic"])
@pytest.mark.parametrize("b,n", SHAPES)
def test_gelu_dropout_matches_the_eager_expression(b, n, drop):
    gen = torch.Generator().manual_seed(n + 7)
    x = (torch.randn((b, n, 2 * WIDTH), generator=gen) * 2).requires_grad_()
    dy = torch.randn((b, n, 2 * WIDTH), generator=gen)
    want = dropout(F.gelu(x, approximate="tanh"), P, torch.Generator().manual_seed(9) if drop else None)
    got = dit_fused.gelu_dropout(x, P, torch.Generator().manual_seed(9) if drop else None)
    close(got, want)
    close(*grads_of(got, x, dy), *grads_of(want, x, dy))


@pytest.mark.parametrize("shape", [(2, 7, 64), (1, 33, 128), (4, 5, 16)])
def test_the_masks_are_layers_dropouts_bit_for_bit(shape):
    seed = int(np.prod(shape))
    mask = dropout(torch.ones(shape), P, torch.Generator().manual_seed(seed)) != 0
    u = dit_fused.uniforms(shape, P, torch.Generator().manual_seed(seed), "cpu")
    bits = dit_fused.pack_bits(u < 1.0 - P)
    assert bits.shape == (*shape[:-1], shape[-1] // 8) and bits.dtype == torch.uint8
    assert torch.equal(dit_fused.unpack_bits(bits), mask)
    _, saved = dit_fused.gated_residual_fwd_plain(torch.zeros(shape), torch.ones(shape[0], 1, shape[-1]),
                                                  torch.ones(shape), u, None, P)
    assert torch.equal(saved, bits)


def test_the_bits_put_element_j_at_bit_j():
    keep = torch.zeros((1, 16), dtype=torch.bool)
    keep[0, [0, 3, 9, 15]] = True
    assert dit_fused.pack_bits(keep).tolist() == [[0b00001001, 0b10000010]]


@pytest.mark.parametrize("p,gen", [(0.0, torch.Generator()), (P, None)], ids=["p0", "no-generator"])
def test_the_deterministic_pass_draws_nothing(p, gen):
    state = None if gen is None else gen.get_state()
    assert dit_fused.uniforms((2, 3, 8), p, gen, "cpu") is None
    assert gen is None or torch.equal(gen.get_state(), state)


def test_a_probability_of_one_is_refused():
    with pytest.raises(ValueError):
        dit_fused.uniforms((2, 8), 1.0, torch.Generator(), "cpu")


SEED, STEP = 11, 0  # a step with neither guidance drop: text and audio both feed the DiT


def f5_batch(cfg, n=20):
    """Three ragged rows, the last a weight-0 fill row."""
    rng = np.random.default_rng(SEED)
    return {"x": torch.tensor(rng.integers(1, 50, (3, 6))), "x_lengths": torch.tensor([6, 5, 3]),
            "y": torch.tensor(rng.standard_normal((3, n, cfg.n_feats)), dtype=torch.float32),
            "y_lengths": torch.tensor([n, n - 5, n - 9]), "weights": torch.tensor([1.0, 1.0, 0.0])}


def f5_loss_and_grads(model, params, batch):
    """The port's loss and every leaf's gradient, on the draws and masks the
    plain reference's ``losses`` makes at (SEED, STEP)."""
    drop_audio, drop_text = ref.drops(SEED, STEP)
    losses = functional_call(
        model, params, (batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
                        torch.Generator().manual_seed(ref.step_seed(SEED, STEP))),
        {"drop_audio": drop_audio, "drop_text": drop_text, "row_weights": batch["weights"],
         "dropout_generator": torch.Generator().manual_seed(ref.step_seed(SEED, STEP, 0, 2))})
    grads = torch.autograd.grad(losses["loss"], list(params.values()))
    return losses["loss"], dict(zip(params, grads))


def plain_model(model, params):
    plain = ref.F5TTS(dataclasses.asdict(model.cfg))
    plain.load_state_dict({k: v.detach() for k, v in params.items()})
    return plain


@pytest.fixture(scope="module")
def f5():
    cfg = tiny_dit_config()
    model = dit.F5TTS(cfg)
    params = {k: v.requires_grad_() for k, v in dit.init_params(cfg, torch.Generator().manual_seed(2)).items()}
    return model, params


def backward_nodes(loss) -> dict:
    """How often each autograd node type appears in ``loss``'s graph."""
    seen, stack, counts = set(), [loss.grad_fn], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        counts[type(node).__name__] = counts.get(type(node).__name__, 0) + 1
        stack.extend(nxt for nxt, _ in node.next_functions)
    return counts


def test_f5tts_on_the_cpu_takes_the_eager_path(f5):
    """On the CPU the blocks call the four ops as on the card, so each op's
    Function is in the step's graph as often as the card launches its kernel,
    and each runs its plain version: no launch counter moves."""
    model, params = f5
    for counter in dit_fused.COUNTERS:
        counter.reset()
    loss, _ = f5_loss_and_grads(model, params, f5_batch(model.cfg))
    assert np.isfinite(float(loss.detach()))
    assert {c.name: c.launches for c in dit_fused.COUNTERS} == {c.name: 0 for c in dit_fused.COUNTERS}
    depth, nodes = model.cfg.depth, backward_nodes(loss)
    assert {name: nodes.get(name, 0) for name in ("_ModulateBackward", "_RopeHeadsBackward",
                                                  "_GatedResidualBackward", "_GeluDropoutBackward")} == {
        "_ModulateBackward": 2 * depth + 1, "_RopeHeadsBackward": depth,
        "_GatedResidualBackward": 2 * depth, "_GeluDropoutBackward": depth}


def test_the_fused_step_is_the_eager_step(f5):
    """The port's step, its blocks through the four Functions (their plain
    versions on the CPU), against the plain fp32 reference's eager step on
    the same draws and dropout masks: the loss and every leaf's gradient."""
    model, params = f5
    batch = f5_batch(model.cfg)
    got_loss, got = f5_loss_and_grads(model, params, batch)
    plain = plain_model(model, params)
    loss = ref.losses(plain, batch, SEED, STEP)["loss"]
    want = dict(zip(params, torch.autograd.grad(loss, [plain.get_parameter(n) for n in params])))
    assert float(got_loss.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    med = float(np.median([float(g.abs().max()) for g in want.values()]))
    for name, g in want.items():
        assert float((got[name] - g).abs().max()) <= 1e-5 * max(float(g.abs().max()), med), name


def test_the_fused_forward_is_the_eager_one_on_padded_rows_too(f5):
    """The DiT's output at every position, padded rows included, with
    dropout on, against the plain reference's on the same masks (the loss
    alone cannot see the padded rows)."""
    model, params = f5
    model.load_state_dict({k: v.detach() for k, v in params.items()})
    plain = plain_model(model, params)
    cfg = model.cfg
    b, n = 3, 19
    gen = torch.Generator().manual_seed(3)
    xt, cond = torch.randn((b, n, cfg.n_feats), generator=gen), torch.randn((b, n, cfg.n_feats), generator=gen)
    text = torch.randn((b, n, cfg.text_dim), generator=gen)
    t = torch.rand((b,), generator=gen)
    keep = ragged_keep(b, n, 4)
    with torch.no_grad():
        got = model.transformer(xt, cond, text, t, keep[..., None], False, torch.Generator().manual_seed(8))
        want = plain.transformer(xt, cond, text, t, keep, False, torch.Generator().manual_seed(8))
    assert not keep.all()
    close(got, want)


def test_profile_step_reports_no_fused_launch_on_the_cpu(capsys):
    from matcha_tpu_torch.utils import profile_step

    args = ["--model", "f5", "--device", "cpu", "--tiny", "--compute_dtype", "float32", "--batch", "2", "--tx", "8",
            "--frames", "16", "--iters", "1"]
    assert profile_step.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dit_launches_per_step"] == {c.name: 0.0 for c in dit_fused.COUNTERS}
