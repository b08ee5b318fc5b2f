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
products as ``wgmma`` on the tensor cores (fp32 accumulation), fed by TMA
through an ``mbarrier`` ring; at grids smaller than the card (a B=1
request) two warpgroups of a block split the key tiles.  fp32 runs exact
fp32 FMAs, with no TF32 or bf16 downcast anywhere.  The JAX
package sends only T >= 1024 to its kernel, a TPU measurement; the port
sends every attention call on a CUDA tensor to its kernel, at any T.

Gradients.  On a CUDA tensor that requires grad, the call goes through
``MaskedAttention`` (a ``torch.autograd.Function``): its forward is the same
kernel, which then also writes the (B, H, T) fp32 log-sum-exp, and its
backward launches the two backward kernels of ``csrc/masked_attention_bwd.cu``
(``masked_attention_bwd_dkv``, ``masked_attention_bwd_dq``), which replace
the Pallas TPU backward (``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` in the same file).  Without grad the forward
writes no log-sum-exp.  On a CPU tensor autograd runs through the plain
version.  Each backward kernel alone has a plain version of its own
contract, ``masked_attention_bwd_plain`` (from the forward's
``masked_attention_lse_plain``), which the tests and ``chip_smoke.py``
hold it against.  The bf16 kernels read their operands by TMA, which needs
16-byte row strides: a head dim that is not a multiple of 8 is zero-padded
(``pad_head_dim``), the kernels get the true head dim's scale, and the
output and gradients are sliced back.

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
LOG2E = 1.4426950408889634
TMA_HEAD_DIM_MULTIPLE = 8  # bf16 rows of a multiple of 16 bytes

masked_attention_fwd_count = LaunchCounter("masked_attention_fwd")
masked_attention_bwd_dkv_count = LaunchCounter("masked_attention_bwd_dkv")
masked_attention_bwd_dq_count = LaunchCounter("masked_attention_bwd_dq")


def masked_self_attention_plain(q, k, v, key_valid, weights_dropout=None, scale=None):
    """Einsum + boolean key mask: the counterpart of ``attention.py:134-139``.

    Logits are fp32 (bf16 products are exact in fp32); the weights are cast
    to v's dtype before the second product, as in the JAX einsum path.
    ``weights_dropout``, a function of the weights, is the training-mode
    attention-prob dropout of the text encoder (``text_encoder.py:157-174``).
    ``scale`` defaults to 1/√D of q's head dim.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~(key_valid[:, None, None, :] > 0), float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    if weights_dropout is not None:
        weights = weights_dropout(weights)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def masked_attention_lse_plain(q, k, key_valid, scale=None):
    """The forward's fp32 log-sum-exp in log2 units, (B, H, T), as the K1
    kernel writes it: log2 Σ_valid exp2(q·kᵀ·scale·log2e); +inf for a row
    whose batch row has no valid key.  ``scale`` defaults to 1/√D."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale_log2 = LOG2E * scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale_log2
    keep = key_valid[:, None, None, :] > 0
    lse = torch.logsumexp(s.masked_fill(~keep, float("-inf")) * math.log(2.0), dim=-1) / math.log(2.0)
    return torch.where(keep.any(dim=-1), lse, torch.full_like(lse, float("inf")))


def masked_attention_bwd_plain(q, k, v, dout, lse, delta, key_valid, scale=None):
    """dq, dk, dv by the backward kernels' own formulas, in fp32:
    P = exp2(q·kᵀ·scale·log2e − lse) with padded keys 0, dV = Pᵀ·dO,
    dP = dO·vᵀ, dS = P∘(dP − delta), dQ = scale·dS·k, dK = scale·dSᵀ·q.
    ``lse``: (B, H, T) log2 units (``masked_attention_lse_plain``);
    ``delta``: (B, H, T) rowsum(dO∘O); ``scale`` defaults to 1/√D of q's
    head dim.  Returns (dq, dk, dv) in the inputs' dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * LOG2E) - lse.float()[..., None])
    p = p.masked_fill(~(key_valid[:, None, None, :] > 0), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, df)
    dp = torch.einsum("bhqd,bhkd->bhqk", df, vf)
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def pad_head_dim(tensors, multiple: int = TMA_HEAD_DIM_MULTIPLE):
    """The tensors zero-padded along the last (head) dim to a multiple of
    ``multiple``; unchanged when it already is one.  Zero columns add
    nothing to q·kᵀ or dO·vᵀ, so the gradients' first D columns are those
    of the unpadded call at the same scale."""
    d = tensors[0].shape[-1]
    extra = -d % multiple
    if extra == 0:
        return tuple(tensors)
    return tuple(torch.nn.functional.pad(x, (0, extra)) for x in tensors)


def _check_cuda_inputs(q, k, v, key_valid):
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
    return (key_valid > 0).to(torch.uint8).contiguous()


def _kernel_operands(*tensors):
    """The true head dim, its softmax scale, and the tensors as the kernels
    take them: bf16 zero-padded to a head dim the TMA kernels can read."""
    d = tensors[0].shape[-1]
    ins = pad_head_dim(tensors) if tensors[0].dtype == torch.bfloat16 else tensors
    return d, 1.0 / math.sqrt(d), ins


def _launch_fwd(q, k, v, valid_u8, with_lse: bool, layout: int = 0):
    """K1 on CUDA tensors: (out, lse), lse empty unless ``with_lse``.
    ``layout`` (bf16): 0 by shape, 1 one warpgroup per block, 2 two
    warpgroups splitting the keys."""
    d, scale, (q, k, v) = _kernel_operands(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3] if with_lse else (0,), dtype=torch.float32, device=q.device)
    kernels().masked_attention_fwd(q, k, v, valid_u8, out, lse, scale, layout)
    masked_attention_fwd_count.add()
    return out[..., :d], lse


def masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8):
    """The dk, dv kernel's wrapper: (B, H, T, D) CUDA tensors in one dtype,
    the forward's (B, H, T) fp32 ``lse`` and ``delta = rowsum(dout·out)``,
    a (B, T) uint8 key mask.  Returns (dk, dv)."""
    d, scale, (q, k, v, dout) = _kernel_operands(q, k, v, dout)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    kernels().masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8, dk, dv, scale)
    masked_attention_bwd_dkv_count.add()
    return dk[..., :d], dv[..., :d]


def masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8):
    """The dq kernel's wrapper; same inputs as ``masked_attention_bwd_dkv``."""
    d, scale, (q, k, v, dout) = _kernel_operands(q, k, v, dout)
    dq = torch.empty_like(q)
    kernels().masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8, dq, scale)
    masked_attention_bwd_dq_count.add()
    return dq[..., :d]


class MaskedAttention(torch.autograd.Function):
    """K1 forward, K1b backward, on contiguous CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, valid_u8):
        out, lse = _launch_fwd(q, k, v, valid_u8, with_lse=True)
        ctx.save_for_backward(q, k, v, valid_u8, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid_u8, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dk, dv = masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8)
        dq = masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8)
        return dq, dk, dv, None


def masked_attention_fwd(q, k, v, key_valid):
    """The kernel's wrapper: (B, H, T, D) q, k, v and a (B, T) key mask.

    On a CUDA tensor: q, k, v must be contiguous, of one shape and of one
    dtype (float32 or bfloat16), with 1 <= D <= 128; anything else raises.
    The mask may be bool, integer or float (> 0 = valid).  When grad is on
    and q, k or v requires it, the result carries the kernel backward.  On
    a CPU tensor this is the plain version.
    """
    if not q.is_cuda:
        return masked_self_attention_plain(q, k, v, key_valid)
    valid_u8 = _check_cuda_inputs(q, k, v, key_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return MaskedAttention.apply(q, k, v, valid_u8)
    return _launch_fwd(q, k, v, valid_u8, with_lse=False)[0]


def masked_self_attention(q, k, v, key_valid, *, backend: str = "auto"):
    """Softmax(q·kᵀ/√D masked to valid keys)·v; (B, H, T, D) in v's dtype."""
    if backend not in BACKENDS:
        raise ValueError(f"Unknown attention backend {backend!r}")
    if backend == "einsum":
        return masked_self_attention_plain(q, k, v, key_valid)
    return masked_attention_fwd(q, k, v, key_valid)
