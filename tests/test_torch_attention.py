"""Port parity: matcha_tpu_torch.ops.attention vs the JAX einsum path.

The plain version runs on the CPU and is held against
``matcha_tpu.ops.attention.masked_self_attention(backend="einsum")`` and a
float64 numpy oracle (mirroring tests/test_attention.py:64,85).  fp32 on
both sides: tolerance 1e-5, the size of fp32 summation-order differences.

The hand-written CUDA kernel runs only on the card: its test is in
tests/test_torch_cuda_kernels.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.attention import masked_self_attention as jax_attention
from matcha_tpu_torch.ops import attention as ta


def _inputs(seed, b=2, h=3, t=16, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    valid = np.zeros((b, t), np.float32)
    valid[0, :10] = 1.0
    valid[1, :] = 1.0
    return q, k, v, valid


def _oracle(q, k, v, valid):
    logits = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) / math.sqrt(q.shape[-1])
    logits = np.where(valid[:, None, None, :] > 0, logits, -np.inf)
    w = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", w / w.sum(axis=-1, keepdims=True), v)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["auto", "flash", "einsum"])
def test_matches_jax_einsum_with_padding(seed, backend):
    q, k, v, valid = _inputs(seed)
    ours = ta.masked_self_attention(*map(torch.from_numpy, (q, k, v, valid)), backend=backend).numpy()
    ref = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v, valid)), backend="einsum"))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(ours, _oracle(q, k, v, valid), atol=1e-5)


def test_padded_rows_are_finite():
    # padded QUERY rows still attend valid keys — no all-masked softmax
    q = torch.ones((1, 1, 4, 8))
    valid = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    assert torch.isfinite(ta.masked_self_attention(q, q, q, valid)).all()


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v, valid = map(torch.from_numpy, _inputs(3))
    before = ta.masked_attention_fwd_count.launches
    out = ta.masked_attention_fwd(q, k, v, valid)
    assert torch.equal(out, ta.masked_self_attention_plain(q, k, v, valid))
    assert ta.masked_attention_fwd_count.launches == before


def test_kernel_wrappers_take_the_key_mask_where_the_benchmark_reads_it():
    """benchmark/harness.py wraps these module attributes by name and
    records each call's key mask from a fixed position: the forward's 4th
    argument, the backward's 7th, MAS's lengths 2nd and 3rd."""
    import inspect

    from matcha_tpu_torch.ops import mas

    def params(fn):
        return list(inspect.signature(fn).parameters)

    assert params(ta._launch_fwd)[3] == "valid_u8"
    assert params(ta.masked_attention_bwd_dkv)[6] == "valid_u8"
    assert params(ta.masked_attention_bwd_dq)[6] == "valid_u8"
    assert params(mas.maximum_path_indices_kernel)[1:3] == ["x_lengths", "y_lengths"]


def test_autograd_backward_is_one_call_of_the_module_attribute(monkeypatch):
    """``MaskedAttention.backward`` looks the backward up on the module when
    it runs, so a wrapper set there (the benchmark's tracer) sees one call
    per backward, with the forward's out and lse and the key mask at their
    positions, and the forward's chunk as a keyword."""
    q, k, v, valid = map(torch.from_numpy, _inputs(4))
    valid_u8 = valid.to(torch.uint8)
    out = ta.masked_self_attention_plain(q, k, v, valid)
    lse = ta.masked_attention_lse_plain(q, k, valid)
    dout = torch.ones_like(out)
    calls = []

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return tuple(torch.full_like(x, float(i)) for i, x in enumerate(args[:3]))

    monkeypatch.setattr(ta, "masked_attention_bwd_dkv", fake)
    ctx = type("Ctx", (), {"saved_tensors": (q, k, v, valid_u8, out, lse), "chunk": 0})()
    grads = ta.MaskedAttention.backward(ctx, dout)
    (args, kwargs), = calls
    assert len(args) == 7 and kwargs == {"chunk": 0}
    assert args[4] is lse and args[5] is out and args[6] is valid_u8
    assert [float(g[0, 0, 0, 0]) for g in grads[:3]] == [0.0, 1.0, 2.0] and grads[3:] == (None, None)


def test_unknown_backend_raises():
    q = torch.zeros((1, 1, 2, 4))
    with pytest.raises(ValueError):
        ta.masked_self_attention(q, q, q, torch.ones((1, 2)), backend="sdpa")


def test_bf16_plain_output_dtype():
    q, k, v, valid = map(torch.from_numpy, _inputs(4))
    out = ta.masked_self_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), valid)
    assert out.dtype == torch.bfloat16
    # bf16 inputs and bf16 weights: within bf16 rounding of the fp32 result
    np.testing.assert_allclose(
        out.float().numpy(), ta.masked_self_attention_plain(q, k, v, valid).numpy(), atol=5e-2
    )


@pytest.mark.parametrize("d", [3, 12, 36, 44])
def test_zero_padded_head_dim_with_true_scale_matches_jax(d):
    """What the bf16 kernel computes for D % 8 != 0: q, k, v zero-padded to a
    multiple of 8 (``pad_head_dim``), the true head dim's scale, the output
    sliced back; held here through the plain version against the JAX einsum
    path at the unpadded head dim."""
    q, k, v, valid = _inputs(5, d=d)
    qp, kp, vp = ta.pad_head_dim(tuple(map(torch.from_numpy, (q, k, v))))
    assert qp.shape[-1] % 8 == 0 and qp.shape[-1] - d < 8
    ours = ta.masked_self_attention_plain(qp, kp, vp, torch.from_numpy(valid), scale=1.0 / math.sqrt(d))
    assert (ours[..., d:] == 0).all()
    ref = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v, valid)), backend="einsum"))
    np.testing.assert_allclose(ours[..., :d].numpy(), ref, atol=1e-5)
    lse_padded = ta.masked_attention_lse_plain(qp, kp, torch.from_numpy(valid), scale=1.0 / math.sqrt(d))
    lse = ta.masked_attention_lse_plain(*map(torch.from_numpy, (q, k, valid)))
    np.testing.assert_allclose(lse_padded.numpy(), lse.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype,d,padded", [(torch.bfloat16, 40, 40), (torch.bfloat16, 36, 40),
                                            (torch.bfloat16, 5, 8), (torch.float32, 36, 36)])
def test_kernel_operands_pad_only_bf16_head_dims_off_the_tma_multiple(dtype, d, padded):
    x = torch.ones((1, 2, 3, d), dtype=dtype)
    true_d, scale, ins = ta._kernel_operands(x, x, x)
    assert true_d == d and scale == pytest.approx(1.0 / math.sqrt(d))
    assert all(t.shape == (1, 2, 3, padded) and t.dtype == dtype for t in ins)
