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
state_dict is the reference layout.

``DecoderConfig.block_type="conformer"`` swaps every transformer block for
``ConformerBlock`` (JAX ``decoder.py:229-300``).  The reference wraps
lucidrains' ConformerBlock, whose layout the repo cannot check (its oracle
is a stub), so the block's submodule names are this port's own, after the
JAX package's parameter names (``ff1_in``, ``to_q``, ``conv_dw``,
``final_norm`` ...); ``weights.py`` maps them to the JAX paths.

Training mode.  ``Decoder.forward`` takes ``gen``, a ``torch.Generator`` on
the activations' device: with one, dropout runs after each attention output
projection and inside each FFN (JAX ``decoder.py:171,217``), and in a
Conformer block inside both FFNs and after the conv module (``:263,297``);
``gen=None`` is the deterministic pass.  Training keeps unmasked GroupNorm
statistics (``masked_norm=False``).

``DecoderConfig.remat``: each ResnetBlock1D and each transformer or
Conformer block runs under ``torch.utils.checkpoint`` (non-reentrant), as
``nn.remat`` wraps them (JAX ``decoder.py:373-384``), whenever grad is on:
the backward recomputes the block's forward instead of keeping its
activations.  torch's checkpoint restores the global RNG only, so the
block runs on a generator made from a snapshot of ``gen``'s state, in the
forward and again in the recompute, and ``gen`` is then left where the
block's forward left it: masks, loss and gradients are those of the
step without remat.  The recompute launches the attention kernel (with
its log-sum-exp) a second time.  The block also runs with the very
parameter tensors of its forward, which ``torch.func.functional_call``
no longer holds in place when the backward recomputes.

The causal U-Net (``Decoder(..., causal=True)``; CosyVoice 2's
``CausalConditionalDecoder``, cosyvoice/flow/decoder.py, which its flow
stage ``models/cosyflow.py`` trains) is this U-Net with ``CausalBlock1D``
(a conv padded 2 frames on the left → LayerNorm over the channels → Mish)
in place of ``Block1D``, ``CausalResnetBlock1D`` in place of
``ResnetBlock1D``, and each stage's last conv a ``CausalConv1d``; its
``DecoderConfig.act_fn="gelu"`` gives the transformer blocks an exact-GELU
FFN (diffusers' ``GELU``: ``proj`` then GELU) in place of SnakeBeta.  Its
attention takes a ``chunk`` (``ops/attention.py``): > 0 makes every
transformer block chunk-causal.

``DecoderConfig.bf16_norm_stats``: the LayerNorms and GroupNorms take
their statistics in the dtype they compute in (``models/layers.py``); the
GroupNorms compute in fp32 under ``fp32_residual``, so with the default
config only the LayerNorms change.

Tensor parallelism (``parallel/sharding.py``) sets ``tp`` on an
``Attention``, ``FeedForward`` or ``ConformerBlock`` whose projections are
sharded: its input is the identity forward (all-reduced backward), its
heads or hidden channels are this rank's block, and its row-parallel
output layer sums over the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from matcha_tpu_torch.models.config import DecoderConfig
from matcha_tpu_torch.models.layers import (
    Conv1d, ConvTranspose1d, GroupNorm, LayerNorm, Linear, dropout, sinusoidal_time_embedding,
)
from matcha_tpu_torch.ops.attention import masked_self_attention


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

    def __init__(self, dim_in, dim_out, groups=8, dtype=torch.float32, f32_carry=False,
                 f32_stats=True):
        super().__init__()
        self.dtype = dtype
        self.norm_dtype = torch.float32 if f32_carry else dtype
        self.f32_stats = f32_stats
        self.block = nn.ModuleList([
            Conv1d(dim_in, dim_out, 3, dtype=dtype),
            GroupNorm(groups, dim_out, eps=1e-5),
        ])

    def forward(self, x, mask, masked_norm=False):
        m = mask[..., None].to(self.dtype)
        h = self.block[0](x * m)
        h = self.block[1](h, mask if masked_norm else None, out_dtype=self.norm_dtype,
                          f32_stats=self.f32_stats)
        return F.mish(h) * m


class ResnetBlock1D(nn.Module):
    """Two Block1Ds with an additive time embedding and a kernel-1 residual."""

    def __init__(self, dim_in, dim_out, time_emb_dim, groups=8, dtype=torch.float32,
                 f32_carry=False, f32_stats=True):
        super().__init__()
        self.dtype = dtype
        self.mlp = nn.ModuleList([nn.Mish(), Linear(time_emb_dim, dim_out, dtype=dtype)])
        self.block1 = Block1D(dim_in, dim_out, groups, dtype, f32_carry, f32_stats)
        self.block2 = Block1D(dim_out, dim_out, groups, dtype, f32_carry, f32_stats)
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


class GELU(nn.Module):
    """proj → exact GELU (diffusers ``GELU``, ``approximate="none"``)."""

    def __init__(self, dim, inner, dtype=torch.float32):
        super().__init__()
        self.proj = Linear(dim, inner, dtype=dtype)

    def forward(self, x):
        return F.gelu(self.proj(x))


ACTIVATIONS = {"snakebeta": SnakeBeta, "gelu": GELU}


class FeedForward(nn.Module):
    """SnakeBeta (or, ``act_fn="gelu"``, GELU) FFN, mult 4 (reference
    transformer.py FeedForward)."""

    def __init__(self, dim, mult=4, p_dropout=0.0, dtype=torch.float32, act_fn="snakebeta"):
        super().__init__()
        if act_fn not in ACTIVATIONS:
            raise ValueError(f"decoder act_fn {act_fn!r}: one of {tuple(ACTIVATIONS)}")
        self.p_dropout = p_dropout
        self.tp = None  # set by parallel.sharding: the hidden channels are this rank's block
        # index 1 holds the reference's Dropout; it has no weights
        self.net = nn.ModuleList([
            ACTIVATIONS[act_fn](dim, dim * mult, dtype), nn.Identity(), Linear(dim * mult, dim, dtype=dtype)
        ])

    def forward(self, x, gen=None):
        if self.tp is None:
            return self.net[2](dropout(self.net[0](x), self.p_dropout, gen))
        h = self.net[0](self.tp.copy(x))
        return self.net[2](dropout(h, self.p_dropout, gen, self.tp.shard(-1)))


class Attention(nn.Module):
    """Self-attention with bias-free q/k/v projections (diffusers layout)."""

    def __init__(self, dim, num_heads, head_dim, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto"):
        super().__init__()
        inner = num_heads * head_dim
        self.p_dropout = p_dropout
        self.num_heads = num_heads  # this rank's heads under tensor parallelism
        self.head_dim = head_dim
        self.attn_backend = attn_backend
        self.tp = None  # set by parallel.sharding
        self.to_q = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(dim, inner, bias=False, dtype=dtype)
        # index 1 holds the reference's Dropout; it has no weights
        self.to_out = nn.ModuleList([Linear(inner, dim, dtype=dtype), nn.Identity()])

    def forward(self, x, mask, gen=None, chunk=0):
        if self.tp is not None:
            x = self.tp.copy(x)
        out = multi_head(self.to_q(x), self.to_k(x), self.to_v(x), mask, self.num_heads,
                         self.head_dim, self.attn_backend, chunk)
        return dropout(self.to_out[0](out), self.p_dropout, gen)


def multi_head(q, k, v, mask, num_heads, head_dim, backend, chunk=0):
    """(B, T, H·D) projections → masked (``chunk`` > 0: chunk-causal)
    self-attention per head → (B, T, H·D)."""
    b, t, _ = q.shape

    def split(y):
        return y.reshape(b, t, num_heads, head_dim).transpose(1, 2).contiguous()

    out = masked_self_attention(split(q), split(k), split(v), mask, backend=backend, chunk=chunk)
    return out.transpose(1, 2).reshape(b, t, num_heads * head_dim)


class DecoderTransformerBlock(nn.Module):
    """Pre-norm block: LN → attention → LN → SnakeBeta (or GELU) FFN, residual both."""

    def __init__(self, dim, num_heads, head_dim, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto", f32_stats=True, act_fn="snakebeta"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype, f32_stats=f32_stats)
        self.attn1 = Attention(dim, num_heads, head_dim, p_dropout, dtype, attn_backend)
        self.norm3 = LayerNorm(dim, eps=1e-5, dtype=dtype, f32_stats=f32_stats)
        self.ff = FeedForward(dim, p_dropout=p_dropout, dtype=dtype, act_fn=act_fn)

    def forward(self, x, mask, gen=None, chunk=0):
        x = x + self.attn1(self.norm1(x), mask, gen, chunk)
        return x + self.ff(self.norm3(x), gen)


class ConformerBlock(nn.Module):
    """0.5·FFN → MHSA → conv module → 0.5·FFN → LN (JAX ``decoder.py:229-300``).

    FFN: LN → dense ×4 → swish → dropout → dense.  MHSA: LN → q, k, v
    with biases → masked attention (the K1 kernel on the card) → dense, no
    dropout.  Conv module: LN → pointwise GLU → depthwise conv (kernel 31,
    one group per channel, "SAME": 15 frames each side) over the masked
    input → swish → pointwise → dropout.  LayerNorm ε 1e-5.
    """

    def __init__(self, dim, num_heads, head_dim, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto", f32_stats=True, ff_mult=1, conv_expansion=2, conv_kernel=31):
        super().__init__()
        self.dtype = dtype
        self.p_dropout = p_dropout
        self.num_heads = num_heads  # this rank's heads under tensor parallelism
        self.head_dim = head_dim
        self.attn_backend = attn_backend
        self.tp = None  # set by parallel.sharding
        inner = num_heads * head_dim
        hidden = dim * ff_mult * 4
        conv_ch = dim * conv_expansion

        def ln():
            return LayerNorm(dim, eps=1e-5, dtype=dtype, f32_stats=f32_stats)

        self.ff1_norm, self.ff1_in, self.ff1_out = ln(), Linear(dim, hidden, dtype=dtype), Linear(hidden, dim, dtype=dtype)
        self.attn_norm = ln()
        self.to_q = Linear(dim, inner, dtype=dtype)
        self.to_k = Linear(dim, inner, dtype=dtype)
        self.to_v = Linear(dim, inner, dtype=dtype)
        self.to_out = Linear(inner, dim, dtype=dtype)
        self.conv_norm = ln()
        self.conv_in = Linear(dim, 2 * conv_ch, dtype=dtype)
        self.conv_dw = Conv1d(conv_ch, conv_ch, conv_kernel, groups=conv_ch, dtype=dtype)
        self.conv_out = Linear(conv_ch, dim, dtype=dtype)
        self.ff2_norm, self.ff2_in, self.ff2_out = ln(), Linear(dim, hidden, dtype=dtype), Linear(hidden, dim, dtype=dtype)
        self.final_norm = ln()

    def _ffn(self, x, norm, lin_in, lin_out, gen):
        h = F.silu(lin_in(norm(x)))
        return lin_out(dropout(h, self.p_dropout, gen))

    def forward(self, x, mask, gen=None):
        m = mask[..., None].to(self.dtype)
        x = x + 0.5 * self._ffn(x, self.ff1_norm, self.ff1_in, self.ff1_out, gen)

        h = self.attn_norm(x)
        if self.tp is not None:
            h = self.tp.copy(h)
        out = multi_head(self.to_q(h), self.to_k(h), self.to_v(h), mask, self.num_heads,
                         self.head_dim, self.attn_backend)
        x = x + self.to_out(out)

        a, g = self.conv_in(self.conv_norm(x)).chunk(2, dim=-1)
        h = F.silu(self.conv_dw(a * torch.sigmoid(g) * m))
        x = x + dropout(self.conv_out(h), self.p_dropout, gen)

        x = x + 0.5 * self._ffn(x, self.ff2_norm, self.ff2_in, self.ff2_out, gen)
        return self.final_norm(x)


def remat_call(module: nn.Module, *args, gen: torch.Generator | None = None, **kwargs):
    """``module(*args[, gen], **kwargs)`` under ``torch.utils.checkpoint``
    with its dropout masks replayed in the recompute (see the module doc)."""
    tensors = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    if gen is None:
        def run(*a):
            return functional_call(module, tensors, a, kwargs)

        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    snapshot = gen.get_state()
    after = []

    def run(*a):
        replay = torch.Generator(device=gen.device)
        replay.set_state(snapshot)
        out = functional_call(module, tensors, (*a, replay), kwargs)
        if not after:  # the forward's end state; the recompute's is the same
            after.append(replay.get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    gen.set_state(after[0])
    return out


class CausalConv1d(Conv1d):
    """Conv over time padded ``kernel_size − 1`` frames on the left: frame t
    sees frames up to t (cosyvoice/flow/decoder.py ``CausalConv1d``)."""

    def __init__(self, in_ch, out_ch, kernel_size, *, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, padding=0, dtype=dtype)

    def forward(self, x):
        return super().forward(F.pad(x, (0, 0, self.kernel_size[0] - 1, 0)))


class CausalBlock1D(nn.Module):
    """Masked causal conv3 → LayerNorm over the channels → Mish, masked
    (cosyvoice/flow/decoder.py ``CausalBlock1D``; index 1 holds its
    ``Transpose``).  Under ``f32_carry`` the norm and everything after it
    are fp32; only the conv runs in the compute dtype."""

    def __init__(self, dim_in, dim_out, dtype=torch.float32, f32_carry=False, f32_stats=True):
        super().__init__()
        self.dtype = dtype
        norm_dtype = torch.float32 if f32_carry else dtype
        self.block = nn.ModuleList([
            CausalConv1d(dim_in, dim_out, 3, dtype=dtype), nn.Identity(),
            LayerNorm(dim_out, eps=1e-5, dtype=norm_dtype, f32_stats=f32_stats),
        ])

    def forward(self, x, mask, masked_norm=False):
        m = mask[..., None].to(self.dtype)
        return F.mish(self.block[2](self.block[0](x * m))) * m


class CausalResnetBlock1D(ResnetBlock1D):
    """``ResnetBlock1D`` over two ``CausalBlock1D``s."""

    def __init__(self, dim_in, dim_out, time_emb_dim, dtype=torch.float32, f32_carry=False,
                 f32_stats=True):
        super().__init__(dim_in, dim_out, time_emb_dim, dtype=dtype, f32_carry=f32_carry,
                         f32_stats=f32_stats)
        self.block1 = CausalBlock1D(dim_in, dim_out, dtype, f32_carry, f32_stats)
        self.block2 = CausalBlock1D(dim_out, dim_out, dtype, f32_carry, f32_stats)


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
                 dtype=torch.float32, attn_backend="auto", causal: bool = False):
        super().__init__()
        if cfg.block_type not in ("transformer", "conformer"):
            raise ValueError(f"decoder block_type {cfg.block_type!r}: 'transformer' or 'conformer'")
        if causal and cfg.block_type != "transformer":
            raise ValueError("the causal U-Net has transformer blocks only")
        self.cfg = cfg
        self.dtype = dtype
        self.in_channels = in_channels
        self.f32_carry = cfg.fp32_residual and dtype != torch.float32
        self.carry = torch.float32 if self.f32_carry else dtype
        ch = cfg.channels
        ted = ch[0] * 4
        f32_stats = not cfg.bf16_norm_stats
        kw = dict(dtype=dtype, f32_carry=self.f32_carry, f32_stats=f32_stats)
        act = {} if cfg.block_type == "conformer" else {"act_fn": cfg.act_fn}
        block_cls = ConformerBlock if cfg.block_type == "conformer" else DecoderTransformerBlock
        resnet_cls = CausalResnetBlock1D if causal else ResnetBlock1D

        def last_conv(c):
            return CausalConv1d(c, c, 3, dtype=dtype) if causal else Conv1d(c, c, 3, dtype=dtype)

        def blocks(dim):
            return nn.ModuleList(
                block_cls(dim, cfg.num_heads, cfg.attention_head_dim, cfg.dropout, dtype,
                          attn_backend, f32_stats, **act)
                for _ in range(cfg.n_blocks)
            )

        self.time_mlp = TimestepMLP(in_channels, ted, dtype=dtype)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            dim_in = in_channels if i == 0 else ch[i - 1]
            last = i == len(ch) - 1
            self.down_blocks.append(nn.ModuleList([
                resnet_cls(dim_in, c, ted, **kw),
                blocks(c),
                last_conv(c) if last else Downsample1D(c, dtype),
            ]))
        self.mid_blocks = nn.ModuleList(
            nn.ModuleList([resnet_cls(ch[-1], ch[-1], ted, **kw), blocks(ch[-1])])
            for _ in range(cfg.num_mid_blocks)
        )
        up_ch = tuple(ch[::-1]) + (ch[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(up_ch) - 1):
            out_c = up_ch[i + 1]
            last = i == len(up_ch) - 2
            self.up_blocks.append(nn.ModuleList([
                resnet_cls(2 * up_ch[i], out_c, ted, **kw),
                blocks(out_c),
                last_conv(out_c) if last else Upsample1D(out_c, dtype),
            ]))
        self.final_block = (CausalBlock1D if causal else Block1D)(up_ch[-1], up_ch[-1], **kw)
        # fp32 island: the velocity feeds fp32 ODE math (true fp32 matmul)
        self.final_proj = Conv1d(up_ch[-1], out_channels, 1, dtype=torch.float32)

    def forward(self, x, mask, mu, t, masked_norm: bool = False, gen=None, chunk: int = 0):
        """x: (B, T, n_feats); mu: (B, T, ·), the conditions concatenated
        after x; mask: (B, T) with T divisible by 2**num_downsamples; t: (B,)
        or scalar; ``gen`` turns dropout on; ``chunk`` > 0 makes attention
        chunk-causal.  Returns (B, T, n_feats)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).expand(x.shape[0])
        t_emb = self.time_mlp(sinusoidal_time_embedding(t, self.in_channels))
        h = torch.cat([x, mu], dim=-1).to(self.carry)

        remat = self.cfg.remat and torch.is_grad_enabled()

        def resnet_fwd(resnet, h, m):
            if remat:
                return remat_call(resnet, h, m, t_emb, masked_norm)
            return resnet(h, m, t_emb, masked_norm)

        def blocks_fwd(tblocks, h, m):
            kw = {"chunk": chunk} if chunk else {}
            for blk in tblocks:
                h = remat_call(blk, h, m, gen=gen, **kw) if remat else blk(h, m, gen, **kw)
            return h

        skips, masks = [], [mask]
        for i, (resnet, tblocks, down) in enumerate(self.down_blocks):
            m = masks[-1]
            h = blocks_fwd(tblocks, resnet_fwd(resnet, h, m), m)
            skips.append(h)
            h = down(h * m[..., None].to(self.dtype)).to(self.carry)
            if i < len(self.down_blocks) - 1:
                masks.append(m[:, ::2])

        m = masks[-1]
        for resnet, tblocks in self.mid_blocks:
            h = blocks_fwd(tblocks, resnet_fwd(resnet, h, m), m)

        for resnet, tblocks, up in self.up_blocks:
            m = masks.pop()
            h = torch.cat([h, skips.pop()], dim=-1)
            h = blocks_fwd(tblocks, resnet_fwd(resnet, h, m), m)
            h = up(h * m[..., None].to(self.dtype)).to(self.carry)

        h = self.final_block(h, mask, masked_norm)
        out = self.final_proj(h.float() * mask[..., None])
        return out * mask[..., None]
