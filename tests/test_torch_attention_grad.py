"""Port parity: gradients of the masked attention.

dq, dk, dv of the port's plain path against ``jax.grad`` of the JAX einsum
path, with padded keys, to 1e-5 (fp32 summation order).  A CPU call through
``masked_self_attention`` carries a ``grad_fn``.  The backward kernels'
own contract (``masked_attention_bwd_plain`` fed by
``masked_attention_lse_plain`` and delta = rowsum(dO∘O)) is held against
the same ``jax.grad``, and the head-dim padding the bf16 kernels need
against the unpadded contract.  The kernels themselves run on the card only
(tests/test_torch_cuda_kernels.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.attention import masked_self_attention as jax_attention
from matcha_tpu_torch.ops import attention as ta


def _inputs(seed, b=2, h=3, t=16, d=8):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    valid = np.zeros((b, t), np.float32)
    valid[0, :10] = 1.0
    valid[1, :] = 1.0
    return q, k, v, dout, valid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["auto", "einsum"])
def test_grads_match_jax(seed, backend):
    q, k, v, dout, valid = _inputs(seed)

    def jax_loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, jnp.asarray(valid), backend="einsum") * dout)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ta.masked_self_attention(tq, tk, tv, torch.from_numpy(valid), backend=backend)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, r in zip("qkv", grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=f"d{name}")
    # padded keys of row 0 get no gradient
    assert not grads[1][0, :, 10:].any() and not grads[2][0, :, 10:].any()


def _ragged_inputs(seed, b, h, t, d):
    """Row 0 has one valid key, row 1 all, the rest random lengths."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    lengths = rng.integers(1, t + 1, b)
    lengths[0], lengths[1] = 1, t
    valid = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return q, k, v, dout, valid


def _jax_grads(q, k, v, dout, valid):
    def loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, jnp.asarray(valid), backend="einsum") * dout)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("seed,shape", [(0, (3, 2, 16, 8)), (1, (2, 3, 37, 12)), (2, (4, 1, 64, 48))])
def test_bwd_plain_contract_matches_jax_grad(seed, shape):
    q, k, v, dout, valid = _ragged_inputs(seed, *shape)
    ref = _jax_grads(q, k, v, dout, valid)
    tq, tk, tv, tdo, tvalid = map(torch.from_numpy, (q, k, v, dout, valid))
    lse = ta.masked_attention_lse_plain(tq, tk, tvalid)
    delta = (tdo * ta.masked_self_attention_plain(tq, tk, tv, tvalid)).sum(-1)
    grads = ta.masked_attention_bwd_plain(tq, tk, tv, tdo, lse, delta, tvalid)
    for name, g, r in zip("qkv", grads, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=f"d{name}")
    # padded keys get exactly zero dk, dv
    padded = ~tvalid.bool()[:, None, :, None].expand(grads[1].shape)
    assert not grads[1][padded].any() and not grads[2][padded].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_lse_plain_is_log2_sum_exp2_of_valid_logits(seed):
    q, k, _, _, valid = _ragged_inputs(seed, 2, 3, 20, 8)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(8)
    logits = jnp.where(jnp.asarray(valid)[:, None, None, :] > 0, logits, -jnp.inf)
    ref = np.asarray(jax.nn.logsumexp(logits, axis=-1)) / math.log(2.0)
    got = ta.masked_attention_lse_plain(*map(torch.from_numpy, (q, k, valid)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_lse_plain_is_inf_for_a_row_without_valid_keys():
    q, k, _, _, valid = map(torch.from_numpy, _ragged_inputs(3, 2, 1, 8, 4))
    valid[0] = 0.0
    lse = ta.masked_attention_lse_plain(q, k, valid)
    assert torch.isinf(lse[0]).all() and (lse[0] > 0).all() and torch.isfinite(lse[1]).all()


@pytest.mark.parametrize("d", [5, 12, 36, 100])
def test_head_dim_padding_keeps_the_contract(d):
    q, k, v, dout, valid = map(torch.from_numpy, _ragged_inputs(d, 2, 2, 24, d))
    lse = ta.masked_attention_lse_plain(q, k, valid)
    delta = (dout * ta.masked_self_attention_plain(q, k, v, valid)).sum(-1)
    ref = ta.masked_attention_bwd_plain(q, k, v, dout, lse, delta, valid)
    padded = ta.pad_head_dim((q, k, v, dout))
    width = -(-d // ta.TMA_HEAD_DIM_MULTIPLE) * ta.TMA_HEAD_DIM_MULTIPLE
    assert all(x.shape[-1] == width for x in padded)
    got = ta.masked_attention_bwd_plain(*padded, lse, delta, valid, scale=1.0 / math.sqrt(d))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g[..., :d], r, rtol=0, atol=1e-6)
        assert not g[..., d:].any()


def test_head_dim_padding_leaves_a_multiple_alone():
    xs = tuple(torch.ones(1, 1, 3, 16) for _ in range(4))
    assert all(a is b for a, b in zip(ta.pad_head_dim(xs), xs))


def test_cpu_call_carries_grad_fn():
    q, k, v, _, valid = map(torch.from_numpy, _inputs(2))
    q.requires_grad_()
    out = ta.masked_self_attention(q, k, v, valid)
    assert out.grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 36, 48, 64, 100, 128])
def test_delta_plain_twin_is_the_fp32_rowsum(dtype, d):
    """The backward pre-pass's plain twin (rowsum(dO∘O) summed in the
    kernel's lane order) against the fp32 and float64 rowsums: any order of
    d fp32 adds of fp32 products is within (d + 1)·2⁻²⁴·Σ|dO∘O| of the
    exact sum."""
    gen = torch.Generator().manual_seed(d)
    dout, out = (torch.randn((2, 3, 17, d), generator=gen).to(dtype) for _ in range(2))
    twin = ta.masked_attention_delta_plain(dout, out)
    assert twin.shape == (2, 3, 17) and twin.dtype == torch.float32
    prods = dout.double() * out.double()
    exact, bound = prods.sum(-1), (d + 1) * 2.0 ** -24 * prods.abs().sum(-1)
    assert ((twin.double() - exact).abs() <= bound).all()
    assert ((twin.double() - (dout.float() * out.float()).sum(-1).double()).abs() <= 2 * bound).all()


@pytest.mark.parametrize("d", [8, 40, 64, 72, 128])
def test_delta_plain_twin_adds_every_product_once(d):
    """Integer products sum exactly in fp32: the twin's lanes and chunks
    cover each of the d products once, padded columns adding nothing."""
    dout = torch.ones((1, 2, 3, d), dtype=torch.bfloat16)
    out = torch.arange(d, dtype=torch.float32).expand(1, 2, 3, d).to(torch.bfloat16)
    twin = ta.masked_attention_delta_plain(dout, out)
    assert torch.equal(twin, torch.full((1, 2, 3), float(d * (d - 1) // 2)))
