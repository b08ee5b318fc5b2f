"""Masked self-attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``matcha_tpu/ops/attention.py::masked_self_attention``
(lines 101-139).  Same contract: ``softmax(q·kᵀ/√D)·v`` with PADDED KEYS
excluded from every softmax; every query row, valid or padded, attends the
same valid keys, so padded-row outputs are finite and downstream masks
dispose of them.  Returns (B, H, T, D) in v's dtype.

Kernel note.  ``masked_attention_fwd`` launches the CUDA C++ kernel in
``csrc/masked_attention_fwd.cu``, which replaces the Pallas TPU flash
kernel the JAX package reaches from its flash branch
(``matcha_tpu/ops/attention.py:117-132``; ``_flash_attention_kernel`` in
jax/experimental/pallas/ops/tpu/flash_attention.py).  What bounds it on the
card: at the synthesis path's bf16 shapes (T = 256..512, D = 48..64) reading
q, k, v and writing out once takes a little longer at peak bandwidth than
the 4·B·H·T²·D flops take at the bf16 tensor-core peak, so the design keeps
the (T, T) logits out of device memory entirely.  bf16 runs the two
products on the tensor cores (``mma.sync`` m16n8k16, fp32 accumulation);
fp32 runs exact fp32 FMAs, with no TF32 or bf16 downcast anywhere.  The JAX
package sends only T >= 1024 to its kernel, a TPU measurement; the port
sends every attention call on a CUDA tensor to its kernel, at any T.

Dispatch.  A tensor on the CPU takes the plain version.  A CUDA tensor
launches the kernel or raises; a build or launch failure is never hidden
behind the plain version.  ``backend="einsum"`` asks for the plain version
explicitly, on any device.
"""

from __future__ import annotations

import math

import torch

from matcha_tpu_torch.ops.extension import LaunchCounter, kernels

BACKENDS = ("auto", "flash", "einsum")
MAX_HEAD_DIM = 128

masked_attention_fwd_count = LaunchCounter("masked_attention_fwd")


def masked_self_attention_plain(q, k, v, key_valid):
    """Einsum + boolean key mask: the counterpart of ``attention.py:134-139``.

    Logits are fp32 (bf16 products are exact in fp32); the weights are cast
    to v's dtype before the second product, as in the JAX einsum path.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~(key_valid[:, None, None, :] > 0), float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def masked_attention_fwd(q, k, v, key_valid):
    """The kernel's wrapper: (B, H, T, D) q, k, v and a (B, T) key mask.

    On a CUDA tensor: q, k, v must be contiguous, of one shape and of one
    dtype (float32 or bfloat16), with 1 <= D <= 128; anything else raises.
    The mask may be bool, integer or float (> 0 = valid).  On a CPU tensor
    this is the plain version.
    """
    if not q.is_cuda:
        return masked_self_attention_plain(q, k, v, key_valid)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (B, H, T, D) shape: {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device and key_valid.device == q.device):
        raise ValueError("q, k, v and key_valid must be on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    b, _, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if tuple(key_valid.shape) != (b, t):
        raise ValueError(f"key_valid must be (B, T) = {(b, t)}, got {tuple(key_valid.shape)}")
    valid_u8 = (key_valid > 0).to(torch.uint8).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernels().masked_attention_fwd(q, k, v, valid_u8, out)
    masked_attention_fwd_count.add()
    return out


def masked_self_attention(q, k, v, key_valid, *, backend: str = "auto"):
    """Softmax(q·kᵀ/√D masked to valid keys)·v; (B, H, T, D) in v's dtype."""
    if backend not in BACKENDS:
        raise ValueError(f"Unknown attention backend {backend!r}")
    if backend == "einsum":
        return masked_self_attention_plain(q, k, v, key_valid)
    return masked_attention_fwd(q, k, v, key_valid)
