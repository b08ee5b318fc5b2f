"""CFM estimator: 1D U-Net over mel frames, conditioned on (mu, t).

PyTorch counterpart of ``matcha_tpu/models/decoder.py`` (reference:
matcha/models/components/decoder.py:202-427, transformer.py:14-303):

  input  [x ‖ mu]
  down:  per stage  ResnetBlock1D(+t) → n_blocks x TransformerBlock → stride-2 conv
  mid:   num_mid_blocks x (ResnetBlock1D → blocks)
  up:    skip-concat → ResnetBlock1D → blocks → conv-transpose x2
  head:  Block1D → kernel-1 conv (fp32)

Time-major (B, T, C) with (B, T) masks halved by ``mask[:, ::2]``.  The
submodules carry the reference torch names (``down_blocks.{i}.0`` resnet,
``.1.{b}`` transformer blocks, ``.2`` down/upsample ...), so the
state_dict is the reference layout.  ``ConformerBlock`` is not ported yet.

Training mode.  ``Decoder.forward`` takes ``gen``, a ``torch.Generator`` on
the activations' device: with one, dropout runs after each attention output
projection and inside each FFN (JAX ``decoder.py:171,217``); ``gen=None`` is
the deterministic pass.  Training keeps unmasked GroupNorm statistics
(``masked_norm=False``).  ``DecoderConfig.remat`` is not ported: torch's
checkpoint does not replay a custom generator's dropout masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.config import DecoderConfig
from matcha_tpu_torch.models.layers import (
    Conv1d, ConvTranspose1d, GroupNorm, LayerNorm, Linear, dropout,
)
from matcha_tpu_torch.ops.attention import masked_self_attention


def sinusoidal_time_embedding(t, dim: int, scale: float = 1000.0):
    """t ∈ [0,1] (B,) → (B, dim) sinusoidal features (reference: decoder.py:15-29)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1))
    )
    args = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimestepMLP(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoidal embedding."""

    def __init__(self, in_dim, time_embed_dim, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim, dtype=dtype)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, dtype=dtype)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class Block1D(nn.Module):
    """Masked conv3 → GroupNorm(8) → Mish (reference: decoder.py:32-45).

    ``masked_norm`` takes the GroupNorm statistics over valid frames only,
    which makes bucketed inference invariant to the bucket (see the JAX
    package's Block1D).  Under ``f32_carry`` the norm and everything after
    it are fp32; only the conv runs in the compute dtype.
    """

    def __init__(self, dim_in, dim_out, groups=8, dtype=torch.float32, f32_carry=False):
        super().__init__()
        self.dtype = dtype
        self.norm_dtype = torch.float32 if f32_carry else dtype
        self.block = nn.ModuleList([
            Conv1d(dim_in, dim_out, 3, dtype=dtype),
            GroupNorm(groups, dim_out, eps=1e-5),
        ])

    def forward(self, x, mask, masked_norm=False):
        m = mask[..., None].to(self.dtype)
        h = self.block[0](x * m)
        h = self.block[1](h, mask if masked_norm else None, out_dtype=self.norm_dtype)
        return F.mish(h) * m


class ResnetBlock1D(nn.Module):
    """Two Block1Ds with an additive time embedding and a kernel-1 residual."""

    def __init__(self, dim_in, dim_out, time_emb_dim, groups=8, dtype=torch.float32,
                 f32_carry=False):
        super().__init__()
        self.dtype = dtype
        self.mlp = nn.ModuleList([nn.Mish(), Linear(time_emb_dim, dim_out, dtype=dtype)])
        self.block1 = Block1D(dim_in, dim_out, groups, dtype, f32_carry)
        self.block2 = Block1D(dim_out, dim_out, groups, dtype, f32_carry)
        self.res_conv = Conv1d(dim_in, dim_out, 1, dtype=dtype)

    def forward(self, x, mask, t_emb, masked_norm=False):
        h = self.block1(x, mask, masked_norm)
        h = h + self.mlp[1](F.mish(t_emb))[:, None, :]
        h = self.block2(h, mask, masked_norm)
        return h + self.res_conv(x * mask[..., None].to(self.dtype))


class SnakeBeta(nn.Module):
    """proj → x + (1/exp(beta))·sin²(x·exp(alpha)), log-scale alpha/beta."""

    def __init__(self, dim, inner, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = Linear(dim, inner, dtype=dtype)
        self.alpha = nn.Parameter(torch.zeros(inner))
        self.beta = nn.Parameter(torch.zeros(inner))

    def forward(self, x):
        h = self.proj(x)
        alpha = torch.exp(self.alpha).to(self.dtype)
        inv_beta = (1.0 / (torch.exp(self.beta) + 1e-9)).to(self.dtype)
        return h + inv_beta * torch.sin(h * alpha).square()


class FeedForward(nn.Module):
    """SnakeBeta FFN, mult 4 (reference transformer.py FeedForward)."""

    def __init__(self, dim, mult=4, p_dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.p_dropout = p_dropout
        # index 1 holds the reference's Dropout; it has no weights
        self.net = nn.ModuleList([
            SnakeBeta(dim, dim * mult, dtype), nn.Identity(), Linear(dim * mult, dim, dtype=dtype)
        ])

    def forward(self, x, gen=None):
        return self.net[2](dropout(self.net[0](x), self.p_dropout, gen))


class Attention(nn.Module):
    """Self-attention with bias-free q/k/v projections (diffusers layout)."""

    def __init__(self, dim, num_heads, head_dim, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto"):
        super().__init__()
        inner = num_heads * head_dim
        self.p_dropout = p_dropout
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.attn_backend = attn_backend
        self.to_q = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(dim, inner, bias=False, dtype=dtype)
        # index 1 holds the reference's Dropout; it has no weights
        self.to_out = nn.ModuleList([Linear(inner, dim, dtype=dtype), nn.Identity()])

    def forward(self, x, mask, gen=None):
        b, t, _ = x.shape

        def split(y):
            return y.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

        out = masked_self_attention(
            split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x)), mask,
            backend=self.attn_backend,
        )
        out = out.transpose(1, 2).reshape(b, t, self.num_heads * self.head_dim)
        return dropout(self.to_out[0](out), self.p_dropout, gen)


class DecoderTransformerBlock(nn.Module):
    """Pre-norm block: LN → attention → LN → SnakeBeta FFN, residual both."""

    def __init__(self, dim, num_heads, head_dim, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn1 = Attention(dim, num_heads, head_dim, p_dropout, dtype, attn_backend)
        self.norm3 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.ff = FeedForward(dim, p_dropout=p_dropout, dtype=dtype)

    def forward(self, x, mask, gen=None):
        x = x + self.attn1(self.norm1(x), mask, gen)
        return x + self.ff(self.norm3(x), gen)


class Downsample1D(nn.Module):
    """Stride-2 conv3 with (1, 1) padding, halving the time axis."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample1D(nn.Module):
    """ConvTranspose(k=4, s=2, p=1) doubling the time axis."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.conv = ConvTranspose1d(dim, dim, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Decoder(nn.Module):
    """U-Net velocity estimator v(x, t | mu); (B, T, n_feats) in and out."""

    def __init__(self, cfg: DecoderConfig, in_channels: int, out_channels: int,
                 dtype=torch.float32, attn_backend="auto"):
        super().__init__()
        if cfg.block_type != "transformer":
            raise NotImplementedError(f"decoder block_type {cfg.block_type!r} is not ported")
        if cfg.bf16_norm_stats:
            raise NotImplementedError("bf16_norm_stats is not ported: norms reduce in fp32")
        if cfg.remat:
            raise NotImplementedError(
                "decoder remat is not ported: torch's checkpoint does not replay a "
                "torch.Generator's dropout masks"
            )
        self.cfg = cfg
        self.dtype = dtype
        self.in_channels = in_channels
        self.f32_carry = cfg.fp32_residual and dtype != torch.float32
        self.carry = torch.float32 if self.f32_carry else dtype
        ch = cfg.channels
        ted = ch[0] * 4
        kw = dict(dtype=dtype, f32_carry=self.f32_carry)

        def blocks(dim):
            return nn.ModuleList(
                DecoderTransformerBlock(dim, cfg.num_heads, cfg.attention_head_dim,
                                        cfg.dropout, dtype, attn_backend)
                for _ in range(cfg.n_blocks)
            )

        self.time_mlp = TimestepMLP(in_channels, ted, dtype=dtype)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            dim_in = in_channels if i == 0 else ch[i - 1]
            last = i == len(ch) - 1
            self.down_blocks.append(nn.ModuleList([
                ResnetBlock1D(dim_in, c, ted, **kw),
                blocks(c),
                Conv1d(c, c, 3, dtype=dtype) if last else Downsample1D(c, dtype),
            ]))
        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([ResnetBlock1D(ch[-1], ch[-1], ted, **kw), blocks(ch[-1])])
            for _ in range(cfg.num_mid_blocks)
        )
        up_ch = tuple(ch[::-1]) + (ch[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(up_ch) - 1):
            out_c = up_ch[i + 1]
            last = i == len(up_ch) - 2
            self.up_blocks.append(nn.ModuleList([
                ResnetBlock1D(2 * up_ch[i], out_c, ted, **kw),
                blocks(out_c),
                Conv1d(out_c, out_c, 3, dtype=dtype) if last else Upsample1D(out_c, dtype),
            ]))
        self.final_block = Block1D(up_ch[-1], up_ch[-1], dtype=dtype, f32_carry=self.f32_carry)
        # fp32 island: the velocity feeds fp32 ODE math (true fp32 matmul)
        self.final_proj = Conv1d(up_ch[-1], out_channels, 1, dtype=torch.float32)

    def forward(self, x, mask, mu, t, masked_norm: bool = False, gen=None):
        """x, mu: (B, T, n_feats); mask: (B, T) with T divisible by
        2**num_downsamples; t: (B,) or scalar; ``gen`` turns dropout on.
        Returns (B, T, n_feats)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).expand(x.shape[0])
        t_emb = self.time_mlp(sinusoidal_time_embedding(t, self.in_channels))
        h = torch.cat([x, mu], dim=-1).to(self.carry)

        skips, masks = [], [mask]
        for i, (resnet, tblocks, down) in enumerate(self.down_blocks):
            m = masks[-1]
            h = resnet(h, m, t_emb, masked_norm)
            for blk in tblocks:
                h = blk(h, m, gen)
            skips.append(h)
            h = down(h * m[..., None].to(self.dtype)).to(self.carry)
            if i < len(self.down_blocks) - 1:
                masks.append(m[:, ::2])

        m = masks[-1]
        for resnet, tblocks in self.mid_blocks:
            h = resnet(h, m, t_emb, masked_norm)
            for blk in tblocks:
                h = blk(h, m, gen)

        for resnet, tblocks, up in self.up_blocks:
            m = masks.pop()
            h = torch.cat([h, skips.pop()], dim=-1)
            h = resnet(h, m, t_emb, masked_norm)
            for blk in tblocks:
                h = blk(h, m, gen)
            h = up(h * m[..., None].to(self.dtype)).to(self.carry)

        h = self.final_block(h, mask, masked_norm)
        out = self.final_proj(h.float() * mask[..., None])
        return out * mask[..., None]
