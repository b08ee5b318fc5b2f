"""Time-major layers with flax's dtype semantics.

The JAX package builds its modules from flax.linen layers: each casts its
input and its fp32 parameters to the module's compute ``dtype`` and returns
that dtype, while norms reduce in fp32.  These are the PyTorch counterparts,
on (B, T, C) activations, with parameters stored in the reference torch
layouts (Conv1d ``(out, in, k)``, Linear ``(out, in)``) so that a state_dict
keeps the reference Matcha-TTS names (see ``weights.py``).

fp32 islands (the mel head, the log-duration conv, the decoder's final
projection) are kernel-1 convs, which ``Conv1d`` runs as a matmul: cuBLAS
computes a float32 matmul in full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set (default False), whereas a
float32 cuDNN convolution runs in TF32 while ``torch.backends.cudnn.allow_tf32``
is True (its default).  ``MatchaSynthesizer`` clears both flags on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dropout(x, p: float, generator: torch.Generator | None):
    """flax ``nn.Dropout``: keep each element with probability 1 − p and
    scale it by 1/(1 − p).  ``generator=None`` is the deterministic pass
    (identity), as is p = 0.  The mask is drawn from ``generator`` on x's
    device; torch's global RNG is never used.
    """
    if generator is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


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

    def forward(self, x):
        dt = self.compute_dtype
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.kernel_size[0] == 1 and self.stride[0] == 1 and self.groups == 1:
            return F.linear(x.to(dt), w[:, :, 0], b)
        y = F.conv1d(x.to(dt).transpose(1, 2), w, b, self.stride, self.padding,
                     groups=self.groups)
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

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """Last-axis LayerNorm with fp32 statistics, output in ``dtype``."""

    def __init__(self, dim, *, eps, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the channels of (B, T, C) with fp32 statistics.

    With a (B, T) ``mask`` the statistics cover valid frames only (the JAX
    package's ``masked_stats``); torch's own GroupNorm has no mask.  The
    variance is E[x²] − E[x]², as flax computes it.
    """

    def forward(self, x, mask=None, out_dtype=torch.float32):
        b, t, c = x.shape
        g = self.num_groups
        x32 = x.float().reshape(b, t, g, c // g)
        if mask is None:
            m = torch.ones((b, t, 1, 1), dtype=torch.float32, device=x.device)
        else:
            m = (mask > 0).to(torch.float32)[:, :, None, None]
        count = m.sum(dim=1, keepdim=True) * (c // g)
        mean = (x32 * m).sum(dim=(1, 3), keepdim=True) / count
        mean2 = (x32 * x32 * m).sum(dim=(1, 3), keepdim=True) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return (y * self.weight + self.bias).to(out_dtype)
