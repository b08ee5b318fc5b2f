"""Plain fp32 Matcha-TTS-24k and Vocos-24k: the benchmark's reference.

A frozen, stand-alone copy of the published architecture (Matcha-TTS,
arXiv:2309.03199, as configured by faltiska/Matcha-TTS-24k; Vocos,
arXiv:2306.00814, charactr/vocos-mel-24khz) in plain ``torch`` operations,
float32 throughout, with no kernel, no cache, no batching and no bucket.
It imports nothing of the program it judges.  Parameter names are those of
the reference Matcha-TTS and Vocos checkpoints, so one state_dict loads
into this module and into the program under test alike.

Layout: activations are time-major (B, T, C); Conv1d weights (out, in, k),
ConvTranspose1d (in, out, k), Linear (out, in).

``precision`` on every module that the served configuration computes in
bfloat16 (the encoder and U-Net bodies, the Vocos backbone) quantises the
operands of its products: ``"fp32"`` leaves them as they are (the
reference); ``"fp8"`` rounds inputs and weights to float8 e4m3 with a
per-tensor scale, and the gradients flowing back through them to e5m2
(the control, one precision below bfloat16).  The fp32
islands (mel head, log-duration head, velocity projection, ISTFT head)
stay float32 in both.

Training mode: ``gen`` (a ``torch.Generator``) turns dropout on; masks are
``torch.rand(shape) < 1 - p`` drawn in the modules' order, the way the
published recipe draws them one module after the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = ["fp32"]


class precision:
    """``with precision("fp8"):`` quantises the bf16 bodies' products."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def __enter__(self):
        self.prev = _PRECISION[0]
        _PRECISION[0] = self.name

    def __exit__(self, *exc):
        _PRECISION[0] = self.prev


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (a float8) with a per-tensor scale."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Quant(torch.autograd.Function):
    """fp8 e4m3 values forward; the gradient through them rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def quant(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the active precision."""
    return x if _PRECISION[0] == "fp32" else _Quant.apply(x)


def dropout(x, p: float, gen):
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def sequence_mask(lengths, t: int):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


class Conv1d(nn.Conv1d):
    """Conv over time of (B, T, C); "same" padding for odd kernels."""

    def __init__(self, cin, cout, k, *, stride=1, padding=None, groups=1, bias=True, island=False):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2 if padding is None else padding,
                         groups=groups, bias=bias)
        self.island = island

    def forward(self, x):
        w, xin = (self.weight, x) if self.island else (quant(self.weight), quant(x))
        y = F.conv1d(xin.transpose(1, 2), w, self.bias, self.stride, self.padding, groups=self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.ConvTranspose1d):
    def forward(self, x):
        y = F.conv_transpose1d(quant(x).transpose(1, 2), quant(self.weight), self.bias, self.stride, self.padding)
        return y.transpose(1, 2)


class Linear(nn.Linear):
    def __init__(self, cin, cout, *, bias=True, island=False):
        super().__init__(cin, cout, bias=bias)
        self.island = island

    def forward(self, x):
        if self.island:
            return F.linear(x, self.weight, self.bias)
        return F.linear(quant(x), quant(self.weight), self.bias)


def attention(q, k, v, key_valid, weights_dropout=None):
    """softmax(q·kᵀ/√D) over the valid keys, then ·v; (B, H, T, D)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~key_valid[:, None, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    if weights_dropout is not None:
        w = weights_dropout(w)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


# ---------------------------------------------------------------- encoder


class ChannelLayerNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class ConvSiluNorm(nn.Module):
    def __init__(self, c, k, n_layers, p):
        super().__init__()
        self.p = p
        self.conv_layers = nn.ModuleList(Conv1d(c, c, k) for _ in range(n_layers))
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(c) for _ in range(n_layers))
        self.proj = Conv1d(c, c, 1)

    def forward(self, x, mask, gen):
        m = mask[..., None]
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = dropout(F.silu(norm(conv(h * m))), self.p, gen)
        return (x + self.proj(h)) * m


def rope_tables(max_len: int, rot: int):
    theta = 1.0 / (10_000.0 ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    ang = np.arange(max_len, dtype=np.float64)[:, None] * theta[None, :]
    ang = np.concatenate([ang, ang], axis=1)
    return torch.from_numpy(np.cos(ang).astype(np.float32)), torch.from_numpy(np.sin(ang).astype(np.float32))


class RopeSelfAttention(nn.Module):
    """Rotary embeddings on the first half of each head's dims."""

    def __init__(self, c, n_heads, rope_max_len, p):
        super().__init__()
        self.c, self.h, self.p = c, n_heads, p
        self.d = c // n_heads
        self.rot = int(self.d * 0.5)
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (Conv1d(c, c, 1) for _ in range(4))
        cos, sin = rope_tables(rope_max_len, self.rot)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def rope(self, x):
        r, half, t = self.rot, self.rot // 2, x.shape[-2]
        xr, xp = x[..., :r], x[..., r:]
        neg = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
        return torch.cat([xr * self.rope_cos[:t] + neg * self.rope_sin[:t], xp], dim=-1)

    def forward(self, x, mask, gen):
        b, t, _ = x.shape

        def heads(y):
            return y.reshape(b, t, self.h, self.d).transpose(1, 2)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        drop = None if gen is None or self.p == 0.0 else (lambda w: dropout(w, self.p, gen))
        out = attention(self.rope(q), self.rope(k), v, mask > 0, drop)
        return self.conv_o(out.transpose(1, 2).reshape(b, t, self.c))


class ConvFFN(nn.Module):
    def __init__(self, c, fc, k, p):
        super().__init__()
        self.p = p
        self.conv_1 = Conv1d(c, fc, k)
        self.conv_2 = Conv1d(fc, c, k)

    def forward(self, x, mask, gen):
        m = mask[..., None]
        h = dropout(torch.relu(self.conv_1(x * m)), self.p, gen)
        return self.conv_2(h * m) * m


class TransformerEncoder(nn.Module):
    def __init__(self, c, fc, n_heads, n_layers, k, rope_max_len, p):
        super().__init__()
        self.p = p
        self.attn_layers = nn.ModuleList(RopeSelfAttention(c, n_heads, rope_max_len, p) for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(ChannelLayerNorm(c) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(ConvFFN(c, fc, k, p) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(ChannelLayerNorm(c) for _ in range(n_layers))

    def forward(self, x, mask, gen):
        m = mask[..., None]
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers, self.norm_layers_2):
            x = x * m
            x = n1(x + dropout(attn(x, mask, gen), self.p, gen))
            x = n2(x + dropout(ffn(x, mask, gen), self.p, gen))
        return x * m


class DurationPredictor(nn.Module):
    def __init__(self, cin, spk, dp: dict):
        super().__init__()
        fc = dp["filter_channels"]
        self.p = dp["p_dropout"]
        self.spk_proj = Linear(spk, 2 * fc)
        self.conv_layers = nn.ModuleList(Conv1d(cin if i == 0 else fc, fc, dp["kernel_size"])
                                         for i in range(dp["n_layers"]))
        self.norm_layers = nn.ModuleList(ChannelLayerNorm(fc) for _ in range(dp["n_layers"]))
        self.proj = Conv1d(fc, 1, 1, island=True)

    def forward(self, x, mask, spk, gen):
        gamma, beta = self.spk_proj(spk)[:, None, :].chunk(2, dim=-1)
        m = mask[..., None]
        h = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            h = norm(torch.relu(conv(h * m)))
            h = dropout(h * gamma + beta, self.p, gen)
        return self.proj(h * m)[..., 0] * mask


class TextEncoder(nn.Module):
    def __init__(self, cfg: dict, n_vocab: int):
        super().__init__()
        enc, dp, spk = cfg["encoder"], cfg["duration_predictor"], cfg["spk_emb_dim"]
        c = enc["n_channels"]
        self.c, self.spk = c, spk
        self.emb = nn.Embedding(n_vocab, c)
        self.prenet = ConvSiluNorm(c, enc["prenet_kernel_size"], enc["prenet_layers"], enc["p_dropout"])
        self.encoder = TransformerEncoder(c + spk, enc["filter_channels"], enc["n_heads"], enc["n_layers"],
                                          enc["kernel_size"], enc["rope_max_len"], enc["p_dropout"])
        self.proj_m = nn.Sequential(Conv1d(c + spk, c, 1, island=True), nn.SiLU(),
                                    Conv1d(c, cfg["n_feats"], 1, island=True))
        self.proj_w = DurationPredictor(c + spk, spk, dp)

    def forward(self, ids, mask, spk_enc, spk_dur, gen=None):
        x = self.prenet(self.emb(ids) * math.sqrt(self.c), mask, gen)
        b, t, _ = x.shape
        x = self.encoder(torch.cat([x, spk_enc[:, None, :].expand(b, t, self.spk)], dim=-1), mask, gen)
        mu = self.proj_m(x) * mask[..., None]
        return mu, self.proj_w(x.detach(), mask, spk_dur, gen)


# ---------------------------------------------------------------- U-Net


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channels of (B, T, C); with a mask, statistics over
    the valid frames only."""

    def forward(self, x, mask=None):
        b, t, c = x.shape
        g = self.num_groups
        xg = x.reshape(b, t, g, c // g)
        m = torch.ones((b, t), device=x.device) if mask is None else mask.float()
        m4 = m[:, :, None, None]
        count = m4.sum(dim=1, keepdim=True) * (c // g)
        mean = (xg * m4).sum(dim=(1, 3), keepdim=True) / count
        var = (((xg - mean) * m4).square()).sum(dim=(1, 3), keepdim=True) / count
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return y * self.weight + self.bias


class Block1D(nn.Module):
    def __init__(self, cin, cout, groups=8):
        super().__init__()
        self.block = nn.ModuleList([Conv1d(cin, cout, 3), GroupNorm(groups, cout, eps=1e-5)])

    def forward(self, x, mask, masked_norm):
        m = mask[..., None]
        h = self.block[1](self.block[0](x * m), mask if masked_norm else None)
        return F.mish(h) * m


class ResnetBlock1D(nn.Module):
    def __init__(self, cin, cout, ted):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Mish(), Linear(ted, cout)])
        self.block1 = Block1D(cin, cout)
        self.block2 = Block1D(cout, cout)
        self.res_conv = Conv1d(cin, cout, 1)

    def forward(self, x, mask, t_emb, masked_norm):
        h = self.block1(x, mask, masked_norm) + self.mlp[1](F.mish(t_emb))[:, None, :]
        return self.block2(h, mask, masked_norm) + self.res_conv(x * mask[..., None])


class SnakeBeta(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Linear(dim, inner)
        self.alpha = nn.Parameter(torch.zeros(inner))
        self.beta = nn.Parameter(torch.zeros(inner))

    def forward(self, x):
        h = self.proj(x)
        return h + (1.0 / (torch.exp(self.beta) + 1e-9)) * torch.sin(h * torch.exp(self.alpha)).square()


class FeedForward(nn.Module):
    def __init__(self, dim, p):
        super().__init__()
        self.p = p
        self.net = nn.ModuleList([SnakeBeta(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x, gen):
        return self.net[2](dropout(self.net[0](x), self.p, gen))


class Attention(nn.Module):
    def __init__(self, dim, heads, head_dim, p):
        super().__init__()
        inner = heads * head_dim
        self.h, self.d, self.p = heads, head_dim, p
        self.to_q, self.to_k, self.to_v = (Linear(dim, inner, bias=False) for _ in range(3))
        self.to_out = nn.ModuleList([Linear(inner, dim), nn.Identity()])

    def forward(self, x, mask, gen):
        b, t, _ = x.shape

        def heads(y):
            return y.reshape(b, t, self.h, self.d).transpose(1, 2)

        out = attention(heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x)), mask > 0)
        return dropout(self.to_out[0](out.transpose(1, 2).reshape(b, t, self.h * self.d)), self.p, gen)


class TransformerBlock(nn.Module):
    def __init__(self, dim, heads, head_dim, p):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, p)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, p)

    def forward(self, x, mask, gen):
        x = x + self.attn1(self.norm1(x), mask, gen)
        return x + self.ff(self.norm3(x), gen)


class Downsample1D(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample1D(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv = ConvTranspose1d(dim, dim, 4, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


def time_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1)))
    a = 1000.0 * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)


class TimestepMLP(nn.Module):
    def __init__(self, cin, ted):
        super().__init__()
        self.linear_1 = Linear(cin, ted)
        self.linear_2 = Linear(ted, ted)

    def forward(self, e):
        return self.linear_2(F.silu(self.linear_1(e)))


class Decoder(nn.Module):
    """The U-Net velocity v(x, t | mu), (B, T, n_feats) in and out."""

    def __init__(self, dec: dict, cin: int, cout: int):
        super().__init__()
        ch = tuple(dec["channels"])
        ted = 4 * ch[0]
        self.cin = cin

        def blocks(dim):
            return nn.ModuleList(TransformerBlock(dim, dec["num_heads"], dec["attention_head_dim"], dec["dropout"])
                                 for _ in range(dec["n_blocks"]))

        self.time_mlp = TimestepMLP(cin, ted)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            last = i == len(ch) - 1
            self.down_blocks.append(nn.ModuleList([
                ResnetBlock1D(cin if i == 0 else ch[i - 1], c, ted), blocks(c),
                Conv1d(c, c, 3) if last else Downsample1D(c)]))
        self.mid_blocks = nn.ModuleList(nn.ModuleList([ResnetBlock1D(ch[-1], ch[-1], ted), blocks(ch[-1])])
                                        for _ in range(dec["num_mid_blocks"]))
        up = ch[::-1] + (ch[0],)
        self.up_blocks = nn.ModuleList()
        for i in range(len(up) - 1):
            last = i == len(up) - 2
            self.up_blocks.append(nn.ModuleList([
                ResnetBlock1D(2 * up[i], up[i + 1], ted), blocks(up[i + 1]),
                Conv1d(up[i + 1], up[i + 1], 3) if last else Upsample1D(up[i + 1])]))
        self.final_block = Block1D(up[-1], up[-1])
        self.final_proj = Conv1d(up[-1], cout, 1, island=True)

    def forward(self, x, mask, mu, t, masked_norm=True, gen=None):
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).expand(x.shape[0])
        t_emb = self.time_mlp(time_embedding(t, self.cin))
        h = torch.cat([x, mu], dim=-1)
        skips, masks = [], [mask]
        for i, (res, blks, down) in enumerate(self.down_blocks):
            m = masks[-1]
            h = res(h, m, t_emb, masked_norm)
            for blk in blks:
                h = blk(h, m, gen)
            skips.append(h)
            h = down(h * m[..., None])
            if i < len(self.down_blocks) - 1:
                masks.append(m[:, ::2])
        m = masks[-1]
        for res, blks in self.mid_blocks:
            h = res(h, m, t_emb, masked_norm)
            for blk in blks:
                h = blk(h, m, gen)
        for res, blks, up in self.up_blocks:
            m = masks.pop()
            h = res(torch.cat([h, skips.pop()], dim=-1), m, t_emb, masked_norm)
            for blk in blks:
                h = blk(h, m, gen)
            h = up(h * m[..., None])
        h = self.final_block(h, mask, masked_norm)
        return self.final_proj(h * mask[..., None]) * mask[..., None]


class CFM(nn.Module):
    def __init__(self, estimator):
        super().__init__()
        self.estimator = estimator


class MatchaTTS(nn.Module):
    def __init__(self, cfg: dict, n_vocab: int = 600):
        super().__init__()
        self.cfg = cfg
        self.speaker_embeddings_enc = nn.Embedding(cfg["n_spks"], cfg["spk_emb_dim"])
        self.speaker_embeddings_dur = nn.Embedding(cfg["n_spks"], cfg["spk_emb_dim"])
        self.encoder = TextEncoder(cfg, n_vocab)
        self.decoder = CFM(Decoder(cfg["decoder"], 2 * cfg["n_feats"], cfg["n_feats"]))


# ---------------------------------------------------------------- Vocos


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim, inter):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, inter)
        self.pwconv2 = Linear(inter, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x))), approximate="tanh"))
        return x + self.gamma * h


class VocosBackbone(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.embed = Conv1d(v["input_channels"], v["dim"], 7)
        self.norm = nn.LayerNorm(v["dim"], eps=1e-6)
        self.convnext = nn.ModuleList(ConvNeXtBlock(v["dim"], v["intermediate_dim"]) for _ in range(v["num_layers"]))
        self.final_layer_norm = nn.LayerNorm(v["dim"], eps=1e-6)

    def forward(self, mel):
        h = self.norm(self.embed(mel))
        for blk in self.convnext:
            h = blk(h)
        return self.final_layer_norm(h)


def istft(spec, n_fft: int, hop: int):
    """(B, T, n_fft//2+1) → (B, (T-1)·hop): periodic Hann window, center
    padding removed, as torch.istft(center=True)."""
    n = torch.arange(n_fft, dtype=torch.float64, device=spec.device)
    window = (0.5 * (1.0 - torch.cos(2.0 * math.pi * n / n_fft))).float()
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    b, t, _ = frames.shape
    total = (t - 1) * hop + n_fft
    idx = (torch.arange(t, device=spec.device)[:, None] * hop + torch.arange(n_fft, device=spec.device)[None, :])
    sig = torch.zeros((b, total), device=spec.device).index_add_(1, idx.reshape(-1), frames.reshape(b, -1))
    env = torch.zeros((total,), device=spec.device).index_add_(0, idx.reshape(-1), window.square().repeat(t))
    sig = sig / env.clamp(min=1e-11)
    return sig[:, n_fft // 2: -(n_fft // 2)]


class ISTFTHead(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        self.out = Linear(v["dim"], v["n_fft"] + 2, island=True)

    def forward(self, h):
        mag, phase = self.out(h).chunk(2, dim=-1)
        mag = torch.exp(torch.clamp(mag, max=100.0))
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft(spec, self.v["n_fft"], self.v["hop_length"])


class Vocos(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.backbone = VocosBackbone(v)
        self.head = ISTFTHead(v)

    def forward(self, mel):
        return self.head(self.backbone(mel))
