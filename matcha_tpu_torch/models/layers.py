"""Time-major layers with flax's dtype semantics.

The JAX package builds its modules from flax.linen layers: each casts its
input and its fp32 parameters to the module's compute ``dtype`` and returns
that dtype, while norms reduce in fp32.  These are the PyTorch counterparts,
on (B, T, C) activations, with parameters stored in the reference torch
layouts (Conv1d ``(out, in, k)``, Linear ``(out, in)``) so that a state_dict
keeps the reference Matcha-TTS names (see ``weights.py``).

Norm statistics.  ``LayerNorm(f32_stats=False)`` and
``GroupNorm.forward(f32_stats=False)`` take their statistics in the dtype
the norm computes in, as flax's ``force_float32_reductions=False`` does
(``DecoderConfig.bf16_norm_stats``): x cast to that dtype, E[x] and E[x²]
summed in fp32 and rounded to it, the variance E[x²] − E[x]² and
rsqrt(var + eps) in it, then the fp32 scale and bias applied as flax
casts them.

Tensor parallelism (``parallel/sharding.py``).  A ``Linear`` or ``Conv1d``
whose ``row_parallel`` is set holds a block of its input channels: it
forms its partial product in fp32 from operands rounded to its compute
dtype, sums the partials over the tensor-parallel group, adds its bias
once after the sum and rounds once, as one GEMM with fp32 accumulation
does.  ``dropout(..., shard=...)`` draws the full mask and keeps a block.

fp32 islands (the mel head, the log-duration conv, the decoder's final
projection) are kernel-1 convs, which ``Conv1d`` runs as a matmul: cuBLAS
computes a float32 matmul in full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set (default False), whereas a
float32 cuDNN convolution runs in TF32 while ``torch.backends.cudnn.allow_tf32``
is True (its default).  ``MatchaSynthesizer`` clears both flags on the card.

The helpers every model and the vocoder share live here too: the compute
dtype by name, the sinusoidal time features and the random-weight rule.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def step_seed(seed: int, step: int, *more: int) -> int:
    """A generator seed for step ``step`` of a run seeded with ``seed``
    (and ``more``, e.g. a rank)."""
    words = np.random.SeedSequence([seed, step, *more]).generate_state(2, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1])


def dropout(x, p: float, generator: torch.Generator | None, shard: tuple[int, int, int] | None = None):
    """flax ``nn.Dropout``: keep each element with probability 1 − p and
    scale it by 1/(1 − p).  ``generator=None`` is the deterministic pass
    (identity), as is p = 0.  The mask is drawn from ``generator`` on x's
    device; torch's global RNG is never used.

    ``shard = (dim, index, count)``: x is block ``index`` of ``count``
    equal blocks of a tensor along ``dim``; the mask is drawn for the whole
    tensor and this block of it kept, so that every holder of a block draws
    the same numbers from the generator as one process holding all of it.
    """
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    else:
        dim, index, count = shard
        full = list(x.shape)
        full[dim] *= count
        keep = torch.rand(full, generator=generator, device=x.device) < 1.0 - p
        keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"compute dtype {name!r} not in {tuple(DTYPES)}")
    return DTYPES[name]


def sinusoidal_time_embedding(t, dim: int, scale: float = 1000.0):
    """t ∈ [0,1] (B,) → (B, dim) sinusoidal features (reference: decoder.py:15-29)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1))
    )
    args = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def random_state_dict(module: nn.Module,
                      generator: torch.Generator | np.random.RandomState) -> dict[str, torch.Tensor]:
    """Random weights for ``module`` from ``generator``, by parameter name.

    Matrices and conv kernels: normal with std 1/sqrt(fan-in); norm scales
    one; biases, norm shifts and SnakeBeta's log-scale alpha/beta zero; the
    FiLM projection starts as identity (zero weight, bias [1, 0]) and Vocos'
    layer scale at 1e-6, as the JAX package initialises them.  A numpy
    ``RandomState`` draws the same scheme from numpy's legacy stream, which
    is the same on every machine and numpy version.
    """
    if isinstance(generator, np.random.RandomState):
        def randn(shape):
            return torch.from_numpy(generator.standard_normal(shape).astype(np.float32))
    else:
        def randn(shape):
            return torch.randn(shape, generator=generator)
    out = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "encoder.emb.weight":
            val = randn(shape) * shape[1] ** -0.5
        elif name.startswith("speaker_embeddings"):
            val = randn(shape) * shape[1] ** -0.5
        elif name == "encoder.proj_w.spk_proj.weight":
            val = torch.zeros(shape)
        elif name == "encoder.proj_w.spk_proj.bias":
            val = torch.cat([torch.ones(shape[0] // 2), torch.zeros(shape[0] - shape[0] // 2)])
        elif leaf == "gamma" and name.startswith("backbone.convnext"):
            val = torch.full(shape, 1e-6)
        elif leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
            val = torch.ones(shape)
        elif leaf in ("bias", "beta", "alpha"):
            val = torch.zeros(shape)
        else:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            val = randn(shape) * fan_in ** -0.5
        out[name] = val.to(torch.float32)
    return out


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype of norm statistics and fp32 islands under a compute
    ``dtype``: fp32, or float64 for a float64 reference run."""
    return torch.promote_types(dtype, torch.float32)


class Conv1d(nn.Conv1d):
    """Conv over the time axis of (B, T, C), computed in ``dtype``.

    ``padding=None`` is flax's "SAME" for odd kernels at stride 1.  A
    kernel-1 conv runs as a matmul on the time-major input.
    """

    def __init__(self, in_ch, out_ch, kernel_size, *, stride=1, padding=None,
                 groups=1, bias=True, dtype=torch.float32):
        if padding is None:
            padding = (kernel_size - 1) // 2
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias)
        self.compute_dtype = dtype
        self.row_parallel = None  # a sharding.TPGroup when this conv holds a block of its inputs

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.row_parallel is not None:
            return self.row_parallel.row_output(self._product(x.to(dt).to(wide(dt)), w.to(wide(dt)), None), b)
        return self._product(x.to(dt), w, b)

    def _product(self, x, w, b):
        if self.kernel_size[0] == 1 and self.stride[0] == 1 and self.groups == 1:
            return F.linear(x, w[:, :, 0], b)
        y = F.conv1d(x.transpose(1, 2), w, b, self.stride, self.padding, groups=self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.ConvTranspose1d):
    """Transposed conv over the time axis of (B, T, C), in ``dtype``.

    Weight ``(in, out, k)``.  ConvTranspose1d(k=4, s=2, p=1) equals the
    JAX package's ``ConvTranspose(4, 2, "SAME", transpose_kernel=True)``
    with the kernel laid out by ``convT_k`` (tests/test_converters.py).
    """

    def __init__(self, in_ch, out_ch, kernel_size, *, stride, padding, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose1d(x.to(dt).transpose(1, 2), self.weight.to(dt),
                               self.bias.to(dt), self.stride, self.padding)
        return y.transpose(1, 2)


class Linear(nn.Linear):
    """Dense layer computed in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features, out_features, *, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.row_parallel = None  # a sharding.TPGroup when this layer holds a block of its inputs

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.row_parallel is not None:
            w = wide(dt)
            return self.row_parallel.row_output(F.linear(x.to(dt).to(w), self.weight.to(dt).to(w)), b)
        return F.linear(x.to(dt), self.weight.to(dt), b)


VALID_SUM_BLOCK = 16  # frames a block of valid_frame_means sums by one reduction


def valid_frame_means(sums, mask, per_frame: int):
    """Means over each row's valid frames from per-frame sums ``sums`` (B,
    T, ..., k) of ``per_frame`` elements each: (B, 1, ...) per statistic,
    unbound from the last axis.  ``mask`` (B, T), > 0 = valid.

    The padded length does not change them.  Invalid frames become exact
    zeros; each block of ``VALID_SUM_BLOCK`` frames is summed by a reduction
    of that fixed shape; a running sum walks the block sums in order (one
    sequential scan per column: torch's cumsum on the CPU, and on CUDA
    along an axis that is not the innermost) and its last element adds only
    zeros after the block of the row's last valid frame.  A reduction over
    the whole of T would group its terms by T and round differently in
    every bucket.  No host sync: the shapes alone pick the padding."""
    keep = mask > 0
    b, t = keep.shape
    ones = (1,) * (sums.dim() - 2)
    v = torch.where(keep.reshape(b, t, *ones), sums, 0)
    pad = -t % VALID_SUM_BLOCK
    if pad:
        v = F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
    blocks = v.reshape(b, (t + pad) // VALID_SUM_BLOCK, VALID_SUM_BLOCK, *v.shape[2:]).sum(2)
    total = blocks.cumsum(1)[:, -1:]
    count = keep.sum(1).reshape(b, 1, *ones) * per_frame
    return (total / count).unbind(-1)


def low_precision_stats(x, dims, stat_dtype, mask=None):
    """flax ``_compute_stats`` without fp32 promotion: mean and variance of
    x cast to ``stat_dtype`` over ``dims``, each mean summed in fp32 (float64
    for float64) and rounded to ``stat_dtype``, var = max(0, E[x²] − E[x]²)
    in ``stat_dtype``.  A (B, T) ``mask`` (> 0 = counted) restricts the
    statistics to the valid frames of axis 1, which ``dims`` must hold;
    they are then summed per frame over the other ``dims`` and over frames
    by ``valid_frame_means``, so the padded length does not change them."""
    xs = x.to(stat_dtype)
    acc = wide(stat_dtype)
    if mask is None:
        count = 1
        for d in dims:
            count *= x.shape[d]
        mean = xs.to(acc).sum(dim=dims, keepdim=True) / count
        mean2 = xs.square().to(acc).sum(dim=dims, keepdim=True) / count
    else:
        per_frame = tuple(d for d in dims if d != 1)
        sums = torch.stack((xs.to(acc).sum(dim=per_frame, keepdim=True),
                            xs.square().to(acc).sum(dim=per_frame, keepdim=True)), -1)
        mean, mean2 = valid_frame_means(sums, mask, math.prod(x.shape[d] for d in per_frame))
    mean, mean2 = mean.to(stat_dtype), mean2.to(stat_dtype)
    return mean, torch.clamp(mean2 - mean.square(), min=0.0)


def normalize_low_precision(x, mean, var, eps, scale, bias, out_dtype):
    """flax ``_normalize`` with ``force_float32_reductions=False``:
    (x − mean) · (rsqrt(var + eps) · scale) + bias, the statistics in their
    own dtype and the fp32 scale and bias promoting the product."""
    mul = torch.rsqrt(var + eps) * scale
    return ((x - mean) * mul + bias).to(out_dtype)


class LayerNorm(nn.LayerNorm):
    """Last-axis LayerNorm, output in ``dtype``; fp32 statistics, or with
    ``f32_stats=False`` statistics in ``dtype`` (see the module doc)."""

    def __init__(self, dim, *, eps, dtype=torch.float32, f32_stats=True):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype
        self.f32_stats = f32_stats

    def forward(self, x):
        if not self.f32_stats:
            mean, var = low_precision_stats(x, (-1,), self.compute_dtype)
            return normalize_low_precision(x, mean, var, self.eps, self.weight, self.bias,
                                           self.compute_dtype)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channels of (B, T, C) with fp32 statistics.

    With a (B, T) ``mask`` the statistics cover valid frames only (the JAX
    package's ``masked_stats``); torch's own GroupNorm has no mask.  They
    are then the same numbers at any padded length (``valid_frame_means``),
    so a row's output does not depend on its bucket or its neighbours.  The
    variance is E[x²] − E[x]², as flax computes it.
    """

    def statistics(self, xg, mask=None, out_dtype=torch.float32, f32_stats=True):
        """Mean and variance of ``xg`` (B, T, G, C/G) over time and each
        group's channels, (B, 1, G, 1): fp32 from ``xg.float()``, or with
        ``f32_stats=False`` in ``out_dtype`` (``low_precision_stats``)."""
        if not f32_stats:
            return low_precision_stats(xg, (1, 3), out_dtype, mask)
        x32 = xg.float()
        if mask is None:
            b, t, _, cg = xg.shape
            m = torch.ones((b, t, 1, 1), dtype=torch.float32, device=xg.device)
            count = m.sum(dim=1, keepdim=True) * cg
            mean = (x32 * m).sum(dim=(1, 3), keepdim=True) / count
            mean2 = (x32 * x32 * m).sum(dim=(1, 3), keepdim=True) / count
        else:
            sums = torch.stack((x32.sum(dim=3, keepdim=True), (x32 * x32).sum(dim=3, keepdim=True)), -1)
            mean, mean2 = valid_frame_means(sums, mask, xg.shape[3])
        return mean, torch.clamp(mean2 - mean * mean, min=0.0)

    def forward(self, x, mask=None, out_dtype=torch.float32, f32_stats=True):
        b, t, c = x.shape
        g = self.num_groups
        if mask is not None:
            # channels innermost (a conv hands time innermost): the per-frame
            # sums and the normalisation then run contiguous
            x = x.to(torch.float32 if f32_stats else x.dtype, memory_format=torch.contiguous_format)
        if not f32_stats:  # statistics in out_dtype (see the module doc)
            xg = x.reshape(b, t, g, c // g)
            mean, var = self.statistics(xg, mask, out_dtype, f32_stats=False)
            y = normalize_low_precision(xg, mean, var, self.eps, self.weight.reshape(g, c // g),
                                        self.bias.reshape(g, c // g), out_dtype)
            return y.reshape(b, t, c)
        x32 = x.float().reshape(b, t, g, c // g)
        mean, var = self.statistics(x32, mask)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return (y * self.weight + self.bias).to(out_dtype)
