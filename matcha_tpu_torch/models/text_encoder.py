"""Text encoder: phoneme ids → acoustic prior mu_x + log-durations.

PyTorch counterpart of ``matcha_tpu/models/text_encoder.py`` (reference:
matcha/models/components/text_encoder.py:319-406):

  embed (x sqrt(C)) → ConvSiluNorm prenet (residual)
  → concat broadcast speaker embedding → transformer encoder
    (RoPE on half the head dims, post-norm residuals, conv-FFN)
  → proj_m head (conv-SiLU-conv, fp32)  and  FiLM duration predictor.

Activations are time-major (B, T, C) as in the JAX package.  Submodules
carry the reference torch names (``conv_layers``, ``attn_layers``,
``proj_m.0`` ...), so the state_dict is the reference layout.  Under bf16
compute with ``fp32_residual`` the embedding / residual / norm stream stays
fp32 and only conv and dense inputs are bf16, as in the JAX package.
``dtype=torch.float64`` runs everything in float64, the fp32 islands and
norm statistics included: the float64 reference that the StyleEncoder
gradient checks hold fp32 runs against.

Training mode.  Every ``forward`` takes ``gen``, a ``torch.Generator`` on the
activations' device: with one, dropout runs where the JAX module has it
(prenet, attention probabilities, both residual branches, the FFN, the
duration predictor) and the attention takes the plain einsum so that its
probabilities can be dropped; ``gen=None`` is the deterministic pass.  The
duration predictor reads a detached copy of the encoder output.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.config import DurationPredictorConfig, EncoderConfig
from matcha_tpu_torch.models.layers import Conv1d, Linear, dropout, wide
from matcha_tpu_torch.ops.attention import masked_self_attention, masked_self_attention_plain


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of (B, T, C); fp32 statistics.

    Output in ``dtype``, or fp32 when ``f32_out`` (the fp32 residual carry).
    """

    def __init__(self, channels, eps=1e-5, dtype=torch.float32, f32_out=False):
        super().__init__()
        self.eps = eps
        self.out_dtype = torch.float32 if f32_out else dtype
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xw = x.to(wide(x.dtype))
        mean = xw.mean(dim=-1, keepdim=True)
        var = (xw - mean).square().mean(dim=-1, keepdim=True)
        y = (xw - mean) * torch.rsqrt(var + self.eps)
        return (y * self.gamma + self.beta).to(self.out_dtype)


class ConvSiluNorm(nn.Module):
    """Residual conv prenet: n x [masked conv → LayerNorm → SiLU]."""

    def __init__(self, channels, out_channels, kernel_size, n_layers, p_dropout=0.0,
                 dtype=torch.float32, f32_carry=False):
        super().__init__()
        self.dtype = dtype
        self.p_dropout = p_dropout
        self.conv_layers = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dtype=dtype) for _ in range(n_layers)
        )
        self.norm_layers = nn.ModuleList(
            ChannelLayerNorm(channels, dtype=dtype, f32_out=f32_carry) for _ in range(n_layers)
        )
        self.proj = Conv1d(channels, out_channels, 1, dtype=dtype)

    def forward(self, x, mask, gen=None):
        m = mask[..., None].to(self.dtype)
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = dropout(F.silu(norm(conv(h * m))), self.p_dropout, gen)
        return (x + self.proj(h)) * m


def rope_cache(max_len: int, rot_dim: int, base: float = 10_000.0):
    """RoPE cos/sin tables (max_len, rot_dim), theta ramp duplicated across
    both halves of rot_dim (labml-style [x1, x2] pairing)."""
    theta = 1.0 / (base ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    angles = np.arange(max_len, dtype=np.float64)[:, None] * theta[None, :]
    angles = np.concatenate([angles, angles], axis=1)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x, cos, sin, rot_dim: int):
    """Rotate the first ``rot_dim`` dims of (B, H, T, Dh) queries/keys."""
    x_rope, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    half = rot_dim // 2
    neg_half = torch.cat([-x_rope[..., half:], x_rope[..., :half]], dim=-1)
    t = x.shape[-2]
    rotated = x_rope * cos[:t] + neg_half * sin[:t]
    return torch.cat([rotated, x_pass], dim=-1)


class RopeSelfAttention(nn.Module):
    """Multi-head self-attention with rotary embeddings on half the head
    dims; kernel-1 conv projections (reference: text_encoder.py:176-243)."""

    def __init__(self, channels, n_heads, rope_max_len, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto"):
        super().__init__()
        self.p_dropout = p_dropout
        self.channels = channels
        self.n_heads = n_heads
        self.head_dim = channels // n_heads
        self.rot_dim = int(self.head_dim * 0.5)
        self.dtype = dtype
        self.attn_backend = attn_backend
        self.conv_q = Conv1d(channels, channels, 1, dtype=dtype)
        self.conv_k = Conv1d(channels, channels, 1, dtype=dtype)
        self.conv_v = Conv1d(channels, channels, 1, dtype=dtype)
        self.conv_o = Conv1d(channels, channels, 1, dtype=dtype)
        cos, sin = rope_cache(rope_max_len, self.rot_dim)
        self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)

    def forward(self, x, mask, gen=None):
        b, t, _ = x.shape

        def split_heads(y):
            return y.reshape(b, t, self.n_heads, self.head_dim).transpose(1, 2)

        q, k, v = split_heads(self.conv_q(x)), split_heads(self.conv_k(x)), split_heads(self.conv_v(x))
        # tables cast to the compute dtype, as text_encoder.py:151-153
        cos = self.rope_cos.to(self.dtype)
        sin = self.rope_sin.to(self.dtype)
        q = apply_rope(q, cos, sin, self.rot_dim)
        k = apply_rope(k, cos, sin, self.rot_dim)
        if gen is None or self.p_dropout == 0.0:
            out = masked_self_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), mask, backend=self.attn_backend
            )
        else:  # training: dropout on the attention probabilities
            out = masked_self_attention_plain(
                q, k, v, mask, weights_dropout=lambda w: dropout(w, self.p_dropout, gen)
            )
        out = out.transpose(1, 2).reshape(b, t, self.channels)
        return self.conv_o(out)


class ConvFFN(nn.Module):
    """Position-wise FFN with kernel-k convs (reference: text_encoder.py:246-258)."""

    def __init__(self, in_channels, filter_channels, out_channels, kernel_size,
                 p_dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.p_dropout = p_dropout
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, dtype=dtype)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, dtype=dtype)

    def forward(self, x, mask, gen=None):
        m = mask[..., None].to(self.dtype)
        h = dropout(torch.relu(self.conv_1(x * m)), self.p_dropout, gen)
        return self.conv_2(h * m) * m


class TransformerEncoder(nn.Module):
    """Post-norm stack: [SDPA → LN → convFFN → LN] x n_layers."""

    def __init__(self, hidden_channels, filter_channels, n_heads, n_layers,
                 kernel_size, rope_max_len, p_dropout=0.0, dtype=torch.float32,
                 attn_backend="auto", f32_carry=False):
        super().__init__()
        self.dtype = dtype
        self.p_dropout = p_dropout
        c = hidden_channels
        self.attn_layers = nn.ModuleList(
            RopeSelfAttention(c, n_heads, rope_max_len, p_dropout, dtype=dtype,
                              attn_backend=attn_backend)
            for _ in range(n_layers)
        )
        self.norm_layers_1 = nn.ModuleList(
            ChannelLayerNorm(c, dtype=dtype, f32_out=f32_carry) for _ in range(n_layers)
        )
        self.ffn_layers = nn.ModuleList(
            ConvFFN(c, filter_channels, c, kernel_size, p_dropout, dtype=dtype)
            for _ in range(n_layers)
        )
        self.norm_layers_2 = nn.ModuleList(
            ChannelLayerNorm(c, dtype=dtype, f32_out=f32_carry) for _ in range(n_layers)
        )

    def forward(self, x, mask, gen=None):
        m = mask[..., None].to(self.dtype)
        p = self.p_dropout
        for attn, norm1, ffn, norm2 in zip(
            self.attn_layers, self.norm_layers_1, self.ffn_layers, self.norm_layers_2
        ):
            x = x * m
            x = norm1(x + dropout(attn(x, mask, gen), p, gen))
            x = norm2(x + dropout(ffn(x, mask, gen), p, gen))
        return x * m


class DurationPredictor(nn.Module):
    """Stacked convs with FiLM speaker conditioning → per-token log-duration."""

    def __init__(self, in_channels, spk_emb_dim, cfg: DurationPredictorConfig,
                 dtype=torch.float32, f32_carry=False):
        super().__init__()
        fc = cfg.filter_channels
        self.dtype = dtype
        self.p_dropout = cfg.p_dropout
        self.spk_proj = Linear(spk_emb_dim, 2 * fc, dtype=dtype)
        self.conv_layers = nn.ModuleList(
            Conv1d(in_channels if i == 0 else fc, fc, cfg.kernel_size, dtype=dtype)
            for i in range(cfg.n_layers)
        )
        self.norm_layers = nn.ModuleList(
            ChannelLayerNorm(fc, dtype=dtype, f32_out=f32_carry) for _ in range(cfg.n_layers)
        )
        # the log-duration head is an fp32 island (precision="highest" in
        # the JAX package): a true-fp32 matmul here, see models/layers.py
        self.proj = Conv1d(fc, 1, 1, dtype=wide(dtype))

    def forward(self, x, mask, spk_emb, gen=None):
        gamma, beta = self.spk_proj(spk_emb)[:, None, :].chunk(2, dim=-1)
        m = mask[..., None].to(self.dtype)
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = norm(torch.relu(conv(h * m)))
            h = dropout(h * gamma + beta, self.p_dropout, gen)
        logw = self.proj(h.to(wide(self.dtype)) * mask[..., None])
        return logw[..., 0] * mask


class TextEncoder(nn.Module):
    """Full encoder: ids → (mu_x (B, Tx, n_feats), logw (B, Tx))."""

    def __init__(self, cfg: EncoderConfig, dp_cfg: DurationPredictorConfig,
                 n_vocab: int, spk_emb_dim: int, dtype=torch.float32,
                 attn_backend="auto"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.spk_emb_dim = spk_emb_dim
        c = cfg.n_channels
        self.f32_carry = cfg.fp32_residual and wide(dtype) != dtype
        self.carry = torch.float32 if self.f32_carry else dtype
        self.emb = nn.Embedding(n_vocab, c)
        self.prenet = (
            ConvSiluNorm(c, c, cfg.prenet_kernel_size, cfg.prenet_layers, cfg.p_dropout,
                         dtype=dtype, f32_carry=self.f32_carry)
            if cfg.prenet else None
        )
        self.encoder = TransformerEncoder(
            c + spk_emb_dim, cfg.filter_channels, cfg.n_heads, cfg.n_layers,
            cfg.kernel_size, cfg.rope_max_len, cfg.p_dropout, dtype=dtype,
            attn_backend=attn_backend, f32_carry=self.f32_carry,
        )
        # the mel head is an fp32 island: mu_x anchors the ODE
        self.proj_m = nn.Sequential(
            Conv1d(c + spk_emb_dim, c, 1, dtype=wide(dtype)),
            nn.SiLU(),
            Conv1d(c, cfg.n_feats, 1, dtype=wide(dtype)),
        )
        self.proj_w = DurationPredictor(
            c + spk_emb_dim, spk_emb_dim, dp_cfg, dtype=dtype, f32_carry=self.f32_carry
        )

    def forward(self, x_ids, x_mask, spk_enc, spk_dur, gen=None):
        c = self.cfg.n_channels
        x = self.emb(x_ids).to(self.carry) * math.sqrt(c)
        if self.prenet is not None:
            x = self.prenet(x, x_mask, gen)
        b, t, _ = x.shape
        spk = spk_enc[:, None, :].to(self.carry).expand(b, t, self.spk_emb_dim)
        x = self.encoder(torch.cat([x, spk], dim=-1), x_mask, gen)
        mu_x = self.proj_m(x.to(wide(self.dtype))) * x_mask[..., None]
        # the duration branch must not shape the acoustic representation
        logw = self.proj_w(x.detach(), x_mask, spk_dur, gen)
        return mu_x, logw
