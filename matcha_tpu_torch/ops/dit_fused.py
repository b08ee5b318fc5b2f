"""The DiT block's fp32 glue as hand-written kernels, each with a hand-written backward.

F5-TTS's DiT (``models/dit.py``) wraps every GEMM of its blocks in
memory-bound fp32 work: the adaLN modulation of the carry, RoPE and the head
layout of q, k and v, the attention branch's dropout, row mask and gate, the
FFN's GELU and dropout.  ``models/dit.py`` calls the four ops below on
every device; each is a ``torch.autograd.Function`` whose forward and
backward are, on the card, kernels of ``csrc/dit_fused.cu`` (bf16 or fp32
narrow operands, fp32 statistics, rotation, gates and carry):

  modulate(h, scale, shift, dtype, eps)  LN₀(h)·(1 + scale) + shift in dtype;
                                         saves h and each row's mean and rstd
  rope_heads(q, k, v, rope, heads)       (B, N, H·D) → (B, H, N, D), q and k
                                         rotated over interleaved pairs
  gated_residual(h, g, y, p, gen, keep)  h + g·y′, y′ = dropout(y) with the
                                         padded rows zeroed (attention
                                         branch), or y (FFN: p 0, no keep)
  gelu_dropout(x, p, gen)                dropout(GELU_tanh(x))

They replace no Pallas kernel: the JAX package has no DiT.  Every kernel
has a plain version of its own contract here (``*_plain``): the Functions
run them on a CPU tensor, which is how the CPU tests hold each hand-written
backward against autograd of the formula and the model against its plain
reference, and ``chip_smoke.py`` holds each kernel against them on the
card.

Dropout.  The uniforms are drawn as ``layers.dropout`` draws them,
``torch.rand(shape, generator=gen, device=...)``, in the model's order, and
an element is kept where u < float32(1 − p); so the masks are those of
``layers.dropout`` and of the benchmark's plain reference.  The forward keeps them
as bits (``pack_bits``: a byte a run of 8 elements of the last axis, bit j
element j) for the backward.  ``gen=None`` or p = 0 is the deterministic
pass: nothing is drawn or dropped.

Column sums (d(scale), d(shift), d(g)) go through per-tile partials of
``ROWS_PER_TILE`` rows and a finishing pass, with no float atomics: the
step is the same on every run.
"""

from __future__ import annotations

import torch

from matcha_tpu_torch.ops.extension import LaunchCounter, kernels

ROWS_PER_TILE = 16  # rows a block of the two backward kernels with column sums walks

# launches of each kernel's wrapper, with (B, N, width, dropout on, branch)
modulate_fwd_count = LaunchCounter("dit_modulate_fwd")
modulate_bwd_count = LaunchCounter("dit_modulate_bwd")
rope_heads_fwd_count = LaunchCounter("dit_rope_heads_fwd")
rope_heads_bwd_count = LaunchCounter("dit_rope_heads_bwd")
gated_residual_fwd_count = LaunchCounter("dit_gated_residual_fwd")
gated_residual_bwd_count = LaunchCounter("dit_gated_residual_bwd")
gelu_dropout_fwd_count = LaunchCounter("dit_gelu_dropout_fwd")
gelu_dropout_bwd_count = LaunchCounter("dit_gelu_dropout_bwd")
COUNTERS = (modulate_fwd_count, modulate_bwd_count, rope_heads_fwd_count, rope_heads_bwd_count,
            gated_residual_fwd_count, gated_residual_bwd_count, gelu_dropout_fwd_count,
            gelu_dropout_bwd_count)

def pack_bits(keep: torch.Tensor) -> torch.Tensor:
    """(..., W) bool → (..., W/8) uint8: bit j of byte i is element 8i + j."""
    shifts = torch.arange(8, dtype=torch.uint8, device=keep.device)
    runs = keep.reshape(*keep.shape[:-1], keep.shape[-1] // 8, 8).to(torch.uint8)
    return (runs << shifts).sum(-1, dtype=torch.uint8)


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_bits``: (..., W/8) uint8 → (..., W) bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[..., None] >> shifts) & 1).bool().reshape(*bits.shape[:-1], bits.shape[-1] * 8)


def uniforms(shape, p: float, gen: torch.Generator | None, device) -> torch.Tensor | None:
    """The fp32 uniforms of one dropout mask, drawn as ``layers.dropout``
    draws them; None for the deterministic pass (no generator, or p 0)."""
    if gen is None or p == 0.0:
        return None
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout probability {p} must lie in [0, 1)")
    return torch.rand(shape, generator=gen, device=device)


def _keep(u: torch.Tensor, p: float) -> torch.Tensor:
    return u < 1.0 - p  # float32 against float32(1 − p), as layers.dropout compares


# ---------------------------------------------------------------------------
# plain versions of each kernel's contract
# ---------------------------------------------------------------------------

def modulate_fwd_plain(h, scale, shift, dtype, eps: float):
    """(y, mean, rstd): y = ((h − mean)·rstd)·(1 + scale) + shift in
    ``dtype``; mean and rstd (B, N) fp32, the variance biased."""
    mean = h.mean(-1)
    rstd = torch.rsqrt((h - mean[..., None]).square().mean(-1) + eps)
    y = ((h - mean[..., None]) * rstd[..., None]) * (1.0 + scale) + shift
    return y.to(dtype), mean, rstd


def modulate_bwd_plain(dy, h, scale, mean, rstd):
    """(dh, d(scale), d(shift)): g = dy·(1 + scale), x̂ = (h − mean)·rstd,
    dh = rstd·(g − mean_c(g) − x̂·mean_c(g·x̂)); d(scale) = Σₙ dy·x̂,
    d(shift) = Σₙ dy, (B, 1, C)."""
    dy = dy.float()
    xh = (h - mean[..., None]) * rstd[..., None]
    g = dy * (1.0 + scale)
    dh = rstd[..., None] * (g - g.mean(-1, keepdim=True) - xh * (g * xh).mean(-1, keepdim=True))
    return dh, (dy * xh).sum(1, keepdim=True), dy.sum(1, keepdim=True)


def rope_heads_plain(q, k, v, rope, heads: int, backward: bool = False):
    """Forward: (B, N, H·D) → (B, H, N, D) contiguous, q's and k's pairs
    (x₂ᵢ, x₂ᵢ₊₁) → (x₂ᵢc − x₂ᵢ₊₁s, x₂ᵢ₊₁c + x₂ᵢs) in fp32; ``backward``: the
    heads' gradients back to (B, N, H·D), q's and k's rotated by the
    transpose.  ``rope``: (N, D/2, 2) cos and sin."""
    c, s = rope[:, None, :, 0], rope[:, None, :, 1]

    def rows(x):  # → (B, N, H·D)
        return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], -1) if backward else x

    def rotate(x):
        b, n, inner = x.shape
        x0, x1 = x.float().reshape(b, n, heads, inner // heads // 2, 2).unbind(-1)
        pair = [x0 * c + x1 * s, x1 * c - x0 * s] if backward else [x0 * c - x1 * s, x1 * c + x0 * s]
        return torch.stack(pair, dim=-1).to(x.dtype).reshape(b, n, inner)

    def laid_out(x):
        b, n, _ = x.shape
        return x.contiguous() if backward else x.reshape(b, n, heads, -1).transpose(1, 2).contiguous()

    return laid_out(rotate(rows(q))), laid_out(rotate(rows(k))), laid_out(rows(v))


def gated_residual_fwd_plain(h, g, y, u, keep, p: float):
    """(out, bits): out = h + g·y′ in fp32, y′ = y/(1 − p) where u < 1 − p
    (0 elsewhere; y where u is None), zeroed on rows outside ``keep`` (B,
    N) (None: every row); bits: the kept elements packed, None without u."""
    yp = y.float()
    bits = None
    if u is not None:
        drawn = _keep(u, p)
        bits = pack_bits(drawn)
        yp = torch.where(drawn, yp / (1.0 - p), 0.0)
    if keep is not None:
        yp = yp.masked_fill(~keep[..., None], 0.0)
    return h + g * yp, bits


def gated_residual_bwd_plain(dout, g, y, bits, keep, p: float):
    """(dy, d(g)): dy = dout·g·[kept]/(1 − p) in y's dtype (no /(1 − p)
    without bits); d(g) = Σₙ dout·y′, (B, 1, C)."""
    kept = torch.ones_like(dout, dtype=torch.bool) if bits is None else unpack_bits(bits)
    if keep is not None:
        kept = kept & keep[..., None]
    scale = 1.0 if bits is None else 1.0 - p
    yp = torch.where(kept, y.float() / scale, 0.0)
    dy = torch.where(kept, (dout * g) / scale, 0.0)
    return dy.to(y.dtype), (dout * yp).sum(1, keepdim=True)


def _gelu_grad(x):
    """PyTorch's derivative of GELU-tanh, fp32."""
    beta, kappa = 0.7978845608028654, 0.044715
    t = torch.tanh(beta * (x + kappa * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * beta * (1.0 + 3.0 * kappa * x * x)


def gelu_dropout_fwd_plain(x, u, p: float):
    """(y, bits): y = GELU_tanh(x)/(1 − p) where u < 1 − p, else 0 (no
    dropout where u is None), computed in fp32, in x's dtype."""
    y = torch.nn.functional.gelu(x.float(), approximate="tanh")
    if u is None:
        return y.to(x.dtype), None
    drawn = _keep(u, p)
    return torch.where(drawn, y / (1.0 - p), 0.0).to(x.dtype), pack_bits(drawn)


def gelu_dropout_bwd_plain(dy, x, bits, p: float):
    """dx = dy/(1 − p)·[kept]·GELU′(x) (dy·GELU′(x) without bits), in fp32,
    in x's dtype."""
    d = dy.float() if bits is None else torch.where(unpack_bits(bits), dy.float() / (1.0 - p), 0.0)
    return (d * _gelu_grad(x.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# the kernels' launches (CUDA tensors): outputs allocated here
# ---------------------------------------------------------------------------

def _empty(t):
    return torch.empty(0, device=t.device)


def _tiles(n: int) -> int:
    return (n + ROWS_PER_TILE - 1) // ROWS_PER_TILE


def modulate_fwd(h, scale, shift, dtype, eps: float, branch: str = ""):
    """The kernel's (y, mean, rstd) on the card, the plain version's on the CPU."""
    if not h.is_cuda:
        return modulate_fwd_plain(h, scale, shift, dtype, eps)
    b, n, c = h.shape
    y = torch.empty(h.shape, dtype=dtype, device=h.device)
    mean, rstd = (torch.empty((b, n), dtype=torch.float32, device=h.device) for _ in range(2))
    kernels().dit_modulate_fwd(h, scale, shift, y, mean, rstd, eps)
    modulate_fwd_count.add((b, n, c, False, branch))
    return y, mean, rstd


def modulate_bwd(dy, h, scale, mean, rstd, branch: str = ""):
    if not h.is_cuda:
        return modulate_bwd_plain(dy, h, scale, mean, rstd)
    b, n, c = h.shape
    dh = torch.empty_like(h)
    partials = torch.empty(2 * b * _tiles(n) * c, dtype=torch.float32, device=h.device)
    sums = torch.empty((2, b, 1, c), dtype=torch.float32, device=h.device)
    kernels().dit_modulate_bwd(dy.contiguous(), h, scale, mean, rstd, dh, partials, sums, ROWS_PER_TILE)
    modulate_bwd_count.add((b, n, c, False, branch))
    return dh, sums[0], sums[1]


def rope_heads_fwd(q, k, v, rope, heads: int):
    if not q.is_cuda:
        return rope_heads_plain(q, k, v, rope, heads)
    b, n, inner = q.shape
    out = [torch.empty((b, heads, n, inner // heads), dtype=q.dtype, device=q.device) for _ in range(3)]
    kernels().dit_rope_heads(q, k, v, rope, *out, heads, False)
    rope_heads_fwd_count.add((b, n, inner, False, "attn"))
    return tuple(out)


def rope_heads_bwd(dq, dk, dv, rope, heads: int):
    if not dq.is_cuda:
        return rope_heads_plain(dq, dk, dv, rope, heads, backward=True)
    b, _, n, d = dq.shape
    out = [torch.empty((b, n, heads * d), dtype=dq.dtype, device=dq.device) for _ in range(3)]
    kernels().dit_rope_heads(dq.contiguous(), dk.contiguous(), dv.contiguous(), rope, *out, heads, True)
    rope_heads_bwd_count.add((b, n, heads * d, False, "attn"))
    return tuple(out)


def gated_residual_fwd(h, g, y, u, keep, p: float, branch: str = ""):
    if not h.is_cuda:
        return gated_residual_fwd_plain(h, g, y, u, keep, p)
    b, n, c = h.shape
    out = torch.empty_like(h)
    bits = _empty(h) if u is None else torch.empty((b, n, c // 8), dtype=torch.uint8, device=h.device)
    kernels().dit_gated_residual_fwd(h, g, y, _empty(h) if u is None else u,
                                     _empty(h) if keep is None else keep, out, bits, p)
    gated_residual_fwd_count.add((b, n, c, u is not None, branch))
    return out, None if u is None else bits


def gated_residual_bwd(dout, g, y, bits, keep, p: float, branch: str = ""):
    if not dout.is_cuda:
        return gated_residual_bwd_plain(dout, g, y, bits, keep, p)
    dout = dout.contiguous()
    b, n, c = dout.shape
    dy = torch.empty_like(y)
    partials = torch.empty(b * _tiles(n) * c, dtype=torch.float32, device=dout.device)
    dg = torch.empty((b, 1, c), dtype=torch.float32, device=dout.device)
    kernels().dit_gated_residual_bwd(dout, g, y, _empty(dout) if bits is None else bits,
                                     _empty(dout) if keep is None else keep, dy, partials, dg, p,
                                     ROWS_PER_TILE)
    gated_residual_bwd_count.add((b, n, c, bits is not None, branch))
    return dy, dg


def gelu_dropout_fwd(x, u, p: float):
    if not x.is_cuda:
        return gelu_dropout_fwd_plain(x, u, p)
    b, n, w = x.shape
    y = torch.empty_like(x)
    bits = _empty(x) if u is None else torch.empty((b, n, w // 8), dtype=torch.uint8, device=x.device)
    kernels().dit_gelu_dropout_fwd(x, _empty(x) if u is None else u, y, bits, p)
    gelu_dropout_fwd_count.add((b, n, w, u is not None, "ff"))
    return y, None if u is None else bits


def gelu_dropout_bwd(dy, x, bits, p: float):
    if not x.is_cuda:
        return gelu_dropout_bwd_plain(dy, x, bits, p)
    b, n, w = x.shape
    dx = torch.empty_like(x)
    kernels().dit_gelu_dropout_bwd(dy.contiguous(), x, _empty(x) if bits is None else bits, dx, p)
    gelu_dropout_bwd_count.add((b, n, w, bits is not None, "ff"))
    return dx


# ---------------------------------------------------------------------------
# the autograd Functions and the ops models/dit.py calls
# ---------------------------------------------------------------------------

class _Modulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, scale, shift, dtype, eps, branch):
        y, mean, rstd = modulate_fwd(h, scale, shift, dtype, eps, branch)
        ctx.save_for_backward(h, scale, mean, rstd)
        ctx.branch = branch
        return y

    @staticmethod
    def backward(ctx, dy):
        h, scale, mean, rstd = ctx.saved_tensors
        dh, dscale, dshift = modulate_bwd(dy, h, scale, mean, rstd, ctx.branch)
        return dh, dscale, dshift, None, None, None


class _RopeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rope, heads):
        ctx.save_for_backward(rope)
        ctx.heads = heads
        return rope_heads_fwd(q, k, v, rope, heads)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        (rope,) = ctx.saved_tensors
        return (*rope_heads_bwd(dq, dk, dv, rope, ctx.heads), None, None)


class _GatedResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, g, y, u, keep, p, branch):
        out, bits = gated_residual_fwd(h, g, y, u, keep, p, branch)
        ctx.save_for_backward(g, y, bits, keep)
        ctx.p, ctx.branch = p, branch
        return out

    @staticmethod
    def backward(ctx, dout):
        g, y, bits, keep = ctx.saved_tensors
        dy, dg = gated_residual_bwd(dout, g, y, bits, keep, ctx.p, ctx.branch)
        return dout, dg, dy, None, None, None, None


class _GeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u, p):
        y, bits = gelu_dropout_fwd(x, u, p)
        ctx.save_for_backward(x, bits)
        ctx.p = p
        return y

    @staticmethod
    def backward(ctx, dy):
        x, bits = ctx.saved_tensors
        return gelu_dropout_bwd(dy, x, bits, ctx.p), None, None


def modulate(h, scale, shift, dtype, eps: float, branch: str = "") -> torch.Tensor:
    """LN₀(h)·(1 + scale) + shift in ``dtype``: h (B, N, C) fp32, scale and
    shift (B, 1, C) fp32; ``branch`` ("attn", "ff", "out") labels the launches."""
    return _Modulate.apply(h, scale, shift, dtype, eps, branch)


def rope_heads(q, k, v, rope, heads: int):
    """(q, k, v) (B, N, H·D) → (B, H, N, D) contiguous, q and k rotated by
    ``rope`` (N, D/2, 2)."""
    return _RopeHeads.apply(q, k, v, rope, heads)


def gated_residual(h, g, y, p: float, gen: torch.Generator | None, keep=None, branch: str = ""):
    """h + g·y′ fp32: y′ = dropout(y, p) on ``gen`` with the rows outside
    ``keep`` (B, N) zeroed; the uniforms drawn here, as ``layers.dropout``
    draws them (none for gen None or p 0)."""
    return _GatedResidual.apply(h, g, y, uniforms(y.shape, p, gen, y.device), keep, p, branch)


def gelu_dropout(x, p: float, gen: torch.Generator | None):
    """dropout(GELU_tanh(x), p) on ``gen`` in x's dtype; the uniforms drawn
    here, as ``layers.dropout`` draws them."""
    return _GeluDropout.apply(x, uniforms(x.shape, p, gen, x.device), p)
