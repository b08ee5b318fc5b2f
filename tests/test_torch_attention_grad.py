"""Port parity: gradients of the masked attention.

dq, dk, dv of the port's plain path against ``jax.grad`` of the JAX einsum
path, with padded keys, to 1e-5 (fp32 summation order).  A CPU call through
``masked_self_attention`` carries a ``grad_fn``.  The kernel backward (K1b)
against autograd through the plain version runs on the card only
(tests/test_torch_cuda_kernels.py).
"""

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


def test_cpu_call_carries_grad_fn():
    q, k, v, _, valid = map(torch.from_numpy, _inputs(2))
    q.requires_grad_()
    out = ta.masked_self_attention(q, k, v, valid)
    assert out.grad_fn is not None
