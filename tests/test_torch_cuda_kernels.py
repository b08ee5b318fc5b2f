"""The port's hand-written CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips where no CUDA device
exists.  This file imports torch and the port only, so it runs on a machine
without JAX; ``tests/conftest.py`` imports JAX, so run it without the
conftest there:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances: attention forward max abs error 1e-4 (fp32: summation order,
exp2 against exp) and 2e-2 (bf16 output rounding), each bf16 layout of the
forward on its own as well; the forward's log-sum-exp 1e-3 in log2 units
(fp32 sums in another order), +inf and a NaN output (0 / 0, as the plain
version) on a batch row with no valid key; backward max |err| /
max |ref| of dq, dk, dv, the same two, both through autograd and for the
backward's one launch alone against ``masked_attention_bwd_plain`` fed the
forward kernel's log-sum-exp and ``masked_attention_delta_plain``'s delta
(bf16 dq is summed by fp32 reduce-adds in an order that changes from run
to run, which moves it far less than its bf16 rounding); padded keys get
dk = dv = 0 exactly; MAS indices equal (fp32 adds and maxes in one
order).  The chunk-causal mode (``chunk`` > 0) is held to the same
tolerances against the plain versions with the same chunk, at the flow
estimator's (B, 8, 1504, 64) with chunk 50 and at ragged odd shapes.
"""

import pytest
import torch

from matcha_tpu_torch.ops import attention as ta
from matcha_tpu_torch.ops import mas

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.Generator(device="cuda").manual_seed(0)


def _valid(b, t, gen):
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lengths[0] = 1
    return (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 6, 256, 48), (16, 5, 512, 64), (2, 6, 4000, 48), (3, 5, 333, 64), (2, 2, 37, 8),
                                   (1, 5, 512, 64), (1, 6, 256, 48), (2, 3, 96, 36), (2, 4, 200, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(gen, shape, dtype):
    b, h, t, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(3))
    valid = _valid(b, t, gen)
    out = ta.masked_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    ref = ta.masked_self_attention_plain(q.float(), k.float(), v.float(), valid)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    if dtype == "bfloat16":  # each layout on its own: one warpgroup, two splitting the keys
        valid_u8 = valid.to(torch.uint8)
        for layout in (1, 2):
            got, _ = ta._launch_fwd(q, k, v, valid_u8, with_lse=False, layout=layout)
            torch.cuda.synchronize()
            assert (got.float() - ref).abs().max().item() <= TOL[dtype], layout


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(62, 5, 512, 64), (3, 5, 333, 64), (2, 6, 4000, 48), (1, 5, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_lse_matches_plain_and_empty_rows_on_card(gen, shape, dtype):
    """Ragged key lengths including 1, and batch row 1 with no valid key:
    its output is NaN where the plain version's is, its lse +inf."""
    b, h, t, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(3))
    valid = _valid(b, t, gen)
    if b > 1:
        valid[1] = 0
    for layout in ((1, 2) if dtype == "bfloat16" else (0,)):
        out, lse = ta._launch_fwd(q, k, v, valid.to(torch.uint8), with_lse=True, layout=layout)
        torch.cuda.synchronize()
        ref_lse = ta.masked_attention_lse_plain(q, k, valid)
        ref = ta.masked_self_attention_plain(q.float(), k.float(), v.float(), valid)
        assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
        finite = torch.isfinite(ref_lse)
        assert (lse[finite] - ref_lse[finite]).abs().max().item() <= 1e-3
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        keep = ~torch.isnan(ref)
        assert (out.float()[keep] - ref[keep]).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(62, 5, 512, 64), (29, 5, 544, 64), (3, 5, 333, 64), (2, 6, 4000, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_backward_matches_plain_on_card(gen, shape, dtype):
    b, h, t, d = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt).requires_grad_() for _ in range(3))
    dout = torch.randn(shape, generator=gen, device="cuda").to(dt)
    valid = _valid(b, t, gen)
    before = ta.masked_attention_bwd_count.launches
    grads = torch.autograd.grad(ta.masked_self_attention(q, k, v, valid), (q, k, v), dout)
    torch.cuda.synchronize()
    assert ta.masked_attention_bwd_count.launches == before + 1
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(ta.masked_self_attention_plain(*ref_in, valid), ref_in, dout.float())
    for g, r in zip(grads, ref):
        assert ((g.float() - r).abs().max() / r.abs().max()).item() <= TOL[dtype]


def _bwd_case(gen, shape, dtype):
    """Ragged keys (row 0 one valid key), the forward kernel's out and lse."""
    b, h, t, d = shape
    valid = _valid(b, t, gen)
    valid_u8 = valid.to(torch.uint8)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    out, lse = ta._launch_fwd(q, k, v, valid_u8, with_lse=True)
    return (q, k, v, dout, lse, out, valid_u8), valid


def _rel(got, ref):
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(29, 5, 1088, 64), (2, 6, 4000, 48), (2, 3, 96, 36)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_backward_kernel_matches_its_plain_contract(gen, shape, dtype):
    args, valid = _bwd_case(gen, shape, getattr(torch, dtype))
    q, k, v, dout, lse, out, _ = args
    dq, dk, dv = ta.masked_attention_bwd_dkv(*args)
    dq_alone = ta.masked_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert (lse - ta.masked_attention_lse_plain(q, k, valid)).abs().max().item() <= 1e-3
    delta = ta.masked_attention_delta_plain(dout, out)
    ref = ta.masked_attention_bwd_plain(q.float(), k.float(), v.float(), dout.float(), lse, delta, valid)
    assert _rel(dq_alone, ref[0]) <= TOL[dtype]
    for got, r in zip((dq, dk, dv), ref):
        assert got.shape == q.shape and got.dtype == q.dtype
        assert _rel(got, r) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 5, 333, 64), (3, 6, 200, 48)])
def test_padded_keys_get_exactly_zero_dk_dv(gen, shape):
    args, valid = _bwd_case(gen, shape, torch.bfloat16)
    _, dk, dv = ta.masked_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    padded = (valid == 0)[:, None, :, None].expand(dk.shape)
    assert padded.any()
    assert (dk[padded] == 0).all() and (dv[padded] == 0).all()
    assert (dk[~padded] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(62, 224, 1024), (29, 448, 2176), (3, 37, 333), (2, 1000, 4096),
                                   (3, 512, 700), (3, 513, 700), (2, 512, 4096), (4, 33, 41)])
@pytest.mark.parametrize("values", ["random", "ties"])
def test_mas_kernel_equals_plain_on_card(gen, shape, values):
    """Tx = 512 is the last shape of the one-warp DP kernel, 513 the first of
    the block-wide one; (2, 512, 4096) keeps its decisions in global
    scratch; Ty = 41 takes 4-byte copies (Ty % 4 != 0)."""
    b, t_x, t_y = shape
    v = torch.randn(shape, generator=gen, device="cuda")
    if values == "ties":
        v = torch.full(shape, -1.0, device="cuda")
    xl = torch.randint(1, t_x + 1, (b,), generator=gen, device="cuda")
    yl = torch.randint(1, t_y + 1, (b,), generator=gen, device="cuda")
    xl[0] = 1
    xl[-1], yl[-1] = t_x, t_y
    got = mas.maximum_path_indices_kernel(v, xl, yl)
    torch.cuda.synchronize()
    assert torch.equal(got, mas.maximum_path_indices_plain(v, xl, yl))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((21, 8, 1504, 64), 50), ((3, 5, 333, 64), 25), ((2, 3, 96, 36), 7),
                                         ((2, 4, 200, 128), 64), ((2, 8, 130, 64), 1),
                                         # chunk 0 at the DiT's and base-train's shapes
                                         ((52, 16, 736, 64), 0), ((62, 5, 512, 64), 0), ((29, 5, 1088, 64), 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_kernels_match_plain_on_card(gen, shape, chunk, dtype):
    """K1 with and without lse (each bf16 layout), the backward's launch
    alone and through autograd, chunk-causal (or with chunk 0 at the
    cells' shapes), against the plain versions."""
    b, h, t, d = shape
    dt = getattr(torch, dtype)
    args, valid = _bwd_case(gen, shape, dt)
    q, k, v, dout, _, _, valid_u8 = args
    ref = ta.masked_self_attention_plain(q.float(), k.float(), v.float(), valid, chunk=chunk)
    out = ta.masked_attention_fwd(q, k, v, valid, chunk=chunk)
    layouts = [ta._launch_fwd(q, k, v, valid_u8, False, layout=n, chunk=chunk)[0] for n in (1, 2)] \
        if dtype == "bfloat16" else []
    out_l, lse = ta._launch_fwd(q, k, v, valid_u8, with_lse=True, chunk=chunk)
    dq, dk, dv = ta.masked_attention_bwd_dkv(q, k, v, dout, lse, out_l, valid_u8, chunk=chunk)
    torch.cuda.synchronize()
    for got in (out, out_l, *layouts):
        assert (got.float() - ref).abs().max().item() <= TOL[dtype]
    assert (lse - ta.masked_attention_lse_plain(q, k, valid, chunk=chunk)).abs().max().item() <= 1e-3
    delta = ta.masked_attention_delta_plain(dout, out_l)
    want = ta.masked_attention_bwd_plain(q.float(), k.float(), v.float(), dout.float(), lse, delta, valid,
                                         chunk=chunk)
    for got, r in zip((dq, dk, dv), want):
        assert _rel(got, r) <= TOL[dtype]
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad(ta.masked_self_attention(qg, kg, vg, valid, chunk=chunk), (qg, kg, vg), dout)
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref_g = torch.autograd.grad(ta.masked_self_attention_plain(*ref_in, valid, chunk=chunk), ref_in, dout.float())
    for g, r in zip(grads, ref_g):
        assert _rel(g, r) <= TOL[dtype]


@pytest.mark.cuda
def test_a_chunk_as_long_as_the_rows_masks_nothing(gen):
    """The chunked kernels with one chunk over the whole row give the
    unchunked kernels' output, lse, dk and dv bit for bit."""
    shape = (4, 5, 333, 64)
    args, _ = _bwd_case(gen, shape, torch.bfloat16)
    q, k, v, dout, _, _, valid_u8 = args
    out0, lse0 = ta._launch_fwd(q, k, v, valid_u8, with_lse=True)
    out1, lse1 = ta._launch_fwd(q, k, v, valid_u8, with_lse=True, chunk=shape[2])
    _, dk0, dv0 = ta.masked_attention_bwd_dkv(q, k, v, dout, lse0, out0, valid_u8)
    _, dk1, dv1 = ta.masked_attention_bwd_dkv(q, k, v, dout, lse1, out1, valid_u8, chunk=shape[2])
    torch.cuda.synchronize()
    for a, b in ((out0, out1), (lse0, lse1), (dk0, dk1), (dv0, dv1)):
        assert torch.equal(a, b)
