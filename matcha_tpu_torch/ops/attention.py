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
backward is one call of ``masked_attention_bwd_dkv``, which launches the
backward of ``csrc/masked_attention_bwd.cu`` and replaces the Pallas TPU
backward (``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq`` in
the same file).  bf16 runs it as one warp-specialised pass that computes
dq, dk and dv from the five products the backward needs (S, dP, dV, dK,
dQ), between a pre-pass kernel that computes delta = rowsum(dO∘O) from
the bf16 tensors and a post-pass that writes dq from its fp32
accumulator; the pass adds each key block's dq into that accumulator by
TMA reduce-adds, in an order that changes from run to run, so bf16 dq is
not bit-repeatable (dk, dv are).  Its bound at the DiT's (13,16,2848,64)
is 1,091 µs; the split pair it replaced (a dk/dv kernel, then a dq
kernel, 7 products) could not pass 5/7 of it and reached 23 %.  fp32 runs
the pre-pass and the two exact reference kernels.  Without grad the
forward writes no log-sum-exp.  On a CPU tensor autograd runs through the
plain version.  The backward has a plain version of its own contract,
``masked_attention_bwd_plain`` (from the forward's
``masked_attention_lse_plain`` and ``masked_attention_delta_plain``, the
pre-pass's twin), which the tests and ``chip_smoke.py`` hold it against.
The bf16 kernels read their operands by TMA, which needs 16-byte row
strides: a head dim that is not a multiple of 8 is zero-padded
(``pad_head_dim``), the kernels get the true head dim's scale, and the
output and gradients are sliced back.

Chunk-causal attention.  ``chunk`` = c > 0, on every function here, also
hides from query i every key j ≥ (⌊i/c⌋ + 1)·c, as a streaming model
trains (CosyVoice 2's flow stage: ``models/cosyflow.py``); 0 (the default)
hides padded keys alone.  The kernels end a query block's key loop at the
last key its rows see and start a key block's query loop at the first
query that sees it; ``attention_keep`` is the mask the plain versions
apply.

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
masked_attention_bwd_count = LaunchCounter("masked_attention_bwd")


def attention_keep(key_valid, t: int, chunk: int = 0):
    """(B, 1, T, T) bool: query i sees key j where j is valid and, with
    ``chunk`` c > 0, j < (⌊i/c⌋ + 1)·c."""
    keep = key_valid[:, None, None, :] > 0
    if chunk:
        i = torch.arange(t, device=key_valid.device)
        keep = keep & (i[None, :] < (i[:, None] // chunk + 1) * chunk)
    return keep


def masked_self_attention_plain(q, k, v, key_valid, weights_dropout=None, scale=None, chunk: int = 0):
    """Einsum + boolean key mask: the counterpart of ``attention.py:134-139``.

    Logits are fp32 (bf16 products are exact in fp32), float64 for float64
    inputs; the weights are cast
    to v's dtype before the second product, as in the JAX einsum path.
    ``weights_dropout``, a function of the weights, is the training-mode
    attention-prob dropout of the text encoder (``text_encoder.py:157-174``).
    ``scale`` defaults to 1/√D of q's head dim; ``chunk`` > 0 is chunk-causal.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    wide = torch.promote_types(q.dtype, torch.float32)  # float64 in a float64 reference run
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(wide), k.to(wide)) * scale
    logits = logits.masked_fill(~attention_keep(key_valid, q.shape[2], chunk), float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    if weights_dropout is not None:
        weights = weights_dropout(weights)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def masked_attention_lse_plain(q, k, key_valid, scale=None, chunk: int = 0):
    """The forward's fp32 log-sum-exp in log2 units, (B, H, T), as the K1
    kernel writes it: log2 Σ_visible exp2(q·kᵀ·scale·log2e); +inf for a row
    that sees no valid key.  ``scale`` defaults to 1/√D; ``chunk`` > 0 is
    chunk-causal."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale_log2 = LOG2E * scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale_log2
    keep = attention_keep(key_valid, q.shape[2], chunk)
    lse = torch.logsumexp(s.masked_fill(~keep, float("-inf")) * math.log(2.0), dim=-1) / math.log(2.0)
    return torch.where(keep.any(dim=-1), lse, torch.full_like(lse, float("inf")))


def masked_attention_bwd_plain(q, k, v, dout, lse, delta, key_valid, scale=None, chunk: int = 0):
    """dq, dk, dv by the backward kernels' own formulas, in fp32:
    P = exp2(q·kᵀ·scale·log2e − lse) with padded keys (and, with ``chunk``
    > 0, keys past the query's chunk) 0, dV = Pᵀ·dO,
    dP = dO·vᵀ, dS = P∘(dP − delta), dQ = scale·dS·k, dK = scale·dSᵀ·q.
    ``lse``: (B, H, T) log2 units (``masked_attention_lse_plain``);
    ``delta``: (B, H, T) rowsum(dO∘O); ``scale`` defaults to 1/√D of q's
    head dim.  Returns (dq, dk, dv) in the inputs' dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * LOG2E) - lse.float()[..., None])
    p = p.masked_fill(~attention_keep(key_valid, q.shape[2], chunk), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, df)
    dp = torch.einsum("bhqd,bhkd->bhqk", df, vf)
    ds = p * (dp - delta.float()[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def masked_attention_delta_plain(dout, out, lanes: int = 8, chunk: int = 8):
    """delta = rowsum(dout∘out) in fp32, (B, H, T), summed as the backward's
    pre-pass kernel sums it: lane s of ``lanes`` adds the products of the
    ``chunk``-element chunks s, s + lanes, ... in order, then the lanes' sums
    are added pairwise (lanes 0+1, 2+3, ..., then those pairs), each
    product rounded to fp32 before it is added: the kernel's sum to the
    bit."""
    prod = dout.float() * out.float()
    d = prod.shape[-1]
    prod = torch.nn.functional.pad(prod, (0, -d % (lanes * chunk)))
    prod = prod.reshape(*prod.shape[:-1], -1, lanes, chunk)  # (..., chunk round, lane, element)
    acc = torch.zeros(prod.shape[:-3] + (lanes,), dtype=torch.float32, device=prod.device)
    for m in range(prod.shape[-3]):
        for e in range(chunk):
            acc = acc + prod[..., m, :, e]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


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


def _launch_fwd(q, k, v, valid_u8, with_lse: bool, layout: int = 0, chunk: int = 0):
    """K1 on CUDA tensors: (out, lse), lse empty unless ``with_lse``.
    ``layout`` (bf16): 0 by shape, 1 one warpgroup per block, 2 two
    warpgroups splitting the keys; ``chunk`` > 0: chunk-causal."""
    signature = (tuple(q.shape), str(q.dtype).split(".")[-1], with_lse, chunk)
    d, scale, (q, k, v) = _kernel_operands(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3] if with_lse else (0,), dtype=torch.float32, device=q.device)
    kernels().masked_attention_fwd(q, k, v, valid_u8, out, lse, scale, layout, chunk)
    masked_attention_fwd_count.add(signature)
    return out[..., :d], lse


def masked_attention_bwd_dkv(q, k, v, dout, lse, out, valid_u8, chunk: int = 0):
    """The backward's one launch: (dq, dk, dv) of (B, H, T, D) CUDA tensors
    in one dtype, from the forward's ``out`` and (B, H, T) fp32 ``lse``, a
    (B, T) uint8 key mask and the forward's ``chunk``.  bf16: the delta
    pre-pass, the fused pass and the dq post-pass; fp32: the pre-pass and
    the two reference kernels.  The name (and the mask at position 6) is
    what ``benchmark/harness.py`` records as the backward's launch."""
    signature = (tuple(q.shape), str(q.dtype).split(".")[-1], chunk)
    d, scale, (q, k, v, dout, out) = _kernel_operands(q, k, v, dout, out)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq_acc = torch.empty(q.shape if q.dtype == torch.bfloat16 else (0,), dtype=torch.float32, device=q.device)
    kernels().masked_attention_bwd(q, k, v, dout, out, lse, valid_u8, delta, dq_acc, dq, dk, dv, scale, chunk)
    masked_attention_bwd_count.add(signature)
    return dq[..., :d], dk[..., :d], dv[..., :d]


def masked_attention_bwd_dq(q, k, v, dout, lse, out, valid_u8, chunk: int = 0):
    """dq alone: the first gradient of ``masked_attention_bwd_dkv``'s launch
    (``benchmark/harness.py`` wraps this name beside it)."""
    return masked_attention_bwd_dkv(q, k, v, dout, lse, out, valid_u8, chunk=chunk)[0]


class MaskedAttention(torch.autograd.Function):
    """K1 forward, K1b backward, on contiguous CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, valid_u8, chunk):
        out, lse = _launch_fwd(q, k, v, valid_u8, with_lse=True, chunk=chunk)
        ctx.save_for_backward(q, k, v, valid_u8, out, lse)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid_u8, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = masked_attention_bwd_dkv(q, k, v, dout, lse, out, valid_u8, chunk=ctx.chunk)
        return dq, dk, dv, None, None


def masked_attention_fwd(q, k, v, key_valid, chunk: int = 0):
    """The kernel's wrapper: (B, H, T, D) q, k, v and a (B, T) key mask.

    On a CUDA tensor: q, k, v must be contiguous, of one shape and of one
    dtype (float32 or bfloat16), with 1 <= D <= 128; anything else raises.
    The mask may be bool, integer or float (> 0 = valid).  When grad is on
    and q, k or v requires it, the result carries the kernel backward.  On
    a CPU tensor this is the plain version.
    """
    if not q.is_cuda:
        return masked_self_attention_plain(q, k, v, key_valid, chunk=chunk)
    if chunk < 0:
        raise ValueError(f"chunk must be 0 (none) or positive, got {chunk}")
    valid_u8 = _check_cuda_inputs(q, k, v, key_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return MaskedAttention.apply(q, k, v, valid_u8, chunk)
    return _launch_fwd(q, k, v, valid_u8, with_lse=False, chunk=chunk)[0]


def masked_self_attention(q, k, v, key_valid, *, backend: str = "auto", chunk: int = 0):
    """Softmax(q·kᵀ/√D masked to valid keys, and with ``chunk`` > 0 to the
    query's chunk and those before it)·v; (B, H, T, D) in v's dtype."""
    if backend not in BACKENDS:
        raise ValueError(f"Unknown attention backend {backend!r}")
    if backend == "einsum":
        return masked_self_attention_plain(q, k, v, key_valid, chunk=chunk)
    return masked_attention_fwd(q, k, v, key_valid, chunk=chunk)
