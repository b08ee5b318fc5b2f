"""Plain fp32 F5-TTS v1 Base: the DiT, its flow-matching training step and AdamW.

A stand-alone copy of the published model (arXiv:2410.06885;
SWivid/F5-TTS ``src/f5_tts/model/backbones/dit.py``, ``model/modules.py``,
``model/cfm.py``) in plain ``torch`` operations, float32 throughout.  It
imports nothing of the program it judges, nor JAX.  Parameter names are the
published checkpoint's under ``transformer.``, so one state_dict loads into
this module and into the program alike.  ``tests/plain_f5tts.py`` and
``benchmark/reference/f5tts.py`` are two copies of this file.

The configuration is a dict with the widths of the program's ``DiTConfig``
(``dim``, ``depth``, ``heads``, ``dim_head``, ``ff_mult``, ``text_dim``,
``conv_layers``, ``n_vocab``, ``n_feats``); the module defaults F5's yaml
leaves as they are are the constants below.

Randomness, drawn exactly as the program draws it.  A step's drops come
first, on the host: two uniforms from a CPU ``torch.Generator`` seeded
from ``step_seed(seed, step, 0, 1)``; the audio condition is dropped when
the first is below ``audio_drop_prob``, text and audio both when the
second is below ``cond_drop_prob``.  Then, on a generator of the batch's
device seeded from ``step_seed(seed, step)``: λ (B) by ``uniform_``, the
span's start U (B), x₀ (B, N, C), t (B), in that order.  The dropout masks
come from a generator of that device seeded from ``step_seed(seed, step,
0, 2)``, a stream apart from the step's draws: each block's attention-output
mask (B, N, dim), then its FFN-hidden mask (B, N, ff_mult·dim), as
``torch.rand(shape) < 1 − p``.

Departures from the published code, all for the comparison:
  * the key-padding mask in attention and in the position convs, and the
    attention output zeroed on padded rows (the yaml's
    ``attn_mask_enabled``);
  * fill rows (weight 0) left out of the loss's sum and count;
  * seeded generators in place of Python's ``random()`` and the global RNG;
  * memory: attention runs in query blocks with a hand-written backward that
    recomputes each block's probabilities, and each DiT block runs under
    ``torch.utils.checkpoint`` with its dropout masks drawn before it and
    passed in, so the recompute uses the very masks the forward drew (the
    checkpoint restores only the default generator).  The numbers are those
    of the plain graph up to summation order.

``precision("fp8")`` rounds the inputs and weights of every product the
program computes in bfloat16 (text ConvNeXt, input projection, position
convs, the blocks' linears, the output projection) to float8 e4m3 with a
per-tensor scale, and the gradients through them to e5m2: the control, one
precision below bfloat16.  The time MLP and the adaLN linears are fp32 in
both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
QUERY_BLOCK = 256  # query rows of one attention block
CONV_MULT = 2
FREQ_EMBED_DIM = 256
CONV_POS_KERNEL, CONV_POS_GROUPS = 31, 16
DROPOUT = 0.1
FRAC_LENGTHS = (0.7, 1.0)
AUDIO_DROP_PROB, COND_DROP_PROB = 0.3, 0.2

_PRECISION = ["fp32"]


class precision:
    """``with precision("fp8"):`` quantises the bf16 products' operands."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def __enter__(self):
        self.prev = _PRECISION[0]
        _PRECISION[0] = self.name

    def __exit__(self, *exc):
        _PRECISION[0] = self.prev


def _fp8(x, dtype):
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Quant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def quant(x):
    return x if _PRECISION[0] == "fp32" else _Quant.apply(x)


def step_seed(seed: int, step: int, *more: int) -> int:
    words = np.random.SeedSequence([seed, step, *more]).generate_state(2, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1])


def drops(seed: int, step: int) -> tuple[bool, bool]:
    """(drop audio, drop text) of one step."""
    u = torch.rand((2,), generator=torch.Generator().manual_seed(step_seed(seed, step, 0, 1)))
    both = bool(u[1] < COND_DROP_PROB)
    return bool(u[0] < AUDIO_DROP_PROB) or both, both


class Linear(nn.Linear):
    def __init__(self, cin, cout, *, island=False):
        super().__init__(cin, cout)
        self.island = island

    def forward(self, x):
        if self.island:
            return F.linear(x, self.weight, self.bias)
        return F.linear(quant(x), quant(self.weight), self.bias)


class Conv1d(nn.Conv1d):
    """Conv over time of (B, T, C)."""

    def forward(self, x):
        y = F.conv1d(quant(x).transpose(1, 2), quant(self.weight), self.bias, self.stride, self.padding,
                     groups=self.groups)
        return y.transpose(1, 2)


def mask_rows(x, valid):
    return x.masked_fill(~valid[..., None], 0.0)


class _BlockedAttention(torch.autograd.Function):
    """softmax(q·kᵀ/√D over the valid keys)·v in query blocks; the backward
    recomputes each block's probabilities."""

    @staticmethod
    def probs(qb, k, valid):
        s = torch.einsum("bhqd,bhkd->bhqk", qb, k) / math.sqrt(qb.shape[-1])
        return torch.softmax(s.masked_fill(~valid[:, None, None, :], float("-inf")), dim=-1)

    @staticmethod
    def forward(ctx, q, k, v, valid):
        ctx.save_for_backward(q, k, v, valid)
        out = torch.empty_like(q)
        for s in range(0, q.shape[2], QUERY_BLOCK):
            out[:, :, s:s + QUERY_BLOCK] = _BlockedAttention.probs(q[:, :, s:s + QUERY_BLOCK], k, valid) @ v
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for s in range(0, q.shape[2], QUERY_BLOCK):
            qb, dob = q[:, :, s:s + QUERY_BLOCK], dout[:, :, s:s + QUERY_BLOCK]
            p = _BlockedAttention.probs(qb, k, valid)
            dv += p.transpose(-1, -2) @ dob
            dp = dob @ v.transpose(-1, -2)
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq[:, :, s:s + QUERY_BLOCK] = (ds @ k) * scale
            dk += (ds.transpose(-1, -2) @ qb) * scale
        return dq, dk, dv, None


def rotary(n: int, dim_head: int, device):
    """x-transformers' RotaryEmbedding: angles (N, D), each pair's repeated."""
    inv = 1.0 / (10000 ** (torch.arange(0, dim_head, 2, device=device).float() / dim_head))
    f = torch.einsum("i,j->ij", torch.arange(n, device=device).float(), inv)
    return torch.stack((f, f), dim=-1).reshape(n, dim_head)


def rotate_half(x):
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(dim=-1)
    return torch.stack((-x2, x1), dim=-1).reshape(*x.shape[:-2], -1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim, freq_dim):
        super().__init__()
        self.freq_dim = freq_dim
        self.time_mlp = nn.ModuleList([Linear(freq_dim, dim, island=True), nn.SiLU(),
                                       Linear(dim, dim, island=True)])

    def forward(self, t):
        half = self.freq_dim // 2
        f = torch.exp(torch.arange(half, device=t.device).float() * -(math.log(10000) / (half - 1)))
        e = 1000 * t[:, None] * f[None]
        s = torch.cat((e.sin(), e.cos()), dim=-1)
        return self.time_mlp[2](F.silu(self.time_mlp[0](s)))


class GRN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x):
        gx = torch.norm(x, p=2, dim=1, keepdim=True)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = Linear(dim, hidden)
        self.grn = GRN(hidden)
        self.pwconv2 = Linear(hidden, dim)

    def forward(self, x):
        y = self.norm(self.dwconv(x))
        return x + self.pwconv2(self.grn(F.gelu(self.pwconv1(y))))


class TextEmbedding(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.dim = cfg["text_dim"]
        self.text_embed = nn.Embedding(cfg["n_vocab"] + 1, cfg["text_dim"])
        self.text_blocks = nn.ModuleList([ConvNeXtV2Block(cfg["text_dim"], cfg["text_dim"] * CONV_MULT)
                                          for _ in range(cfg["conv_layers"])])

    def forward(self, x, x_len, n, drop_text):
        text = x.long() + 1
        text = torch.where(torch.arange(x.shape[1], device=x.device)[None] < x_len[:, None], text, 0)
        text = text[:, :n]
        text = F.pad(text, (0, n - text.shape[1]), value=0)
        filler = text == 0
        if drop_text:
            text = torch.zeros_like(text)
        e = self.text_embed(text)
        inv = 1.0 / (10000.0 ** (torch.arange(0, self.dim, 2, device=x.device)[: self.dim // 2].float() / self.dim))
        ang = torch.outer(torch.arange(n, device=x.device).float(), inv)
        e = e + torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        e = e.masked_fill(filler[..., None], 0.0)
        for block in self.text_blocks:
            e = block(e).masked_fill(filler[..., None], 0.0)
        return e


class InputEmbedding(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, k, g = cfg["dim"], CONV_POS_KERNEL, CONV_POS_GROUPS
        self.proj = Linear(2 * cfg["n_feats"] + cfg["text_dim"], d)
        self.conv_pos_embed = nn.Module()
        self.conv_pos_embed.conv1d = nn.ModuleList([Conv1d(d, d, k, padding=k // 2, groups=g), nn.Mish(),
                                                    Conv1d(d, d, k, padding=k // 2, groups=g), nn.Mish()])

    def forward(self, x, cond, text, valid, drop_audio):
        if drop_audio:
            cond = torch.zeros_like(cond)
        h = self.proj(torch.cat((x, cond, text), dim=-1))
        c = self.conv_pos_embed.conv1d
        p = mask_rows(F.mish(c[2](F.mish(c[0](mask_rows(h, valid))))), valid)
        return h + p


class DiTBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, inner = cfg["dim"], cfg["heads"] * cfg["dim_head"]
        self.heads = cfg["heads"]
        self.attn_norm = nn.Module()
        self.attn_norm.linear = Linear(d, 6 * d, island=True)
        self.attn = nn.Module()
        self.attn.to_q, self.attn.to_k, self.attn.to_v = (Linear(d, inner) for _ in range(3))
        self.attn.to_out = nn.ModuleList([Linear(inner, d), nn.Identity()])
        self.ff = nn.Module()
        hidden = d * cfg["ff_mult"]
        self.ff.ff = nn.ModuleList([nn.ModuleList([Linear(d, hidden), nn.GELU("tanh")]), nn.Identity(),
                                    Linear(hidden, d)])
        self.p = DROPOUT

    def forward(self, x, temb, valid, freqs, attn_keep, ff_keep):
        emb = self.attn_norm.linear(F.silu(temb))
        sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(emb, 6, dim=1)
        norm = F.layer_norm(x, x.shape[-1:], eps=LN_EPS) * (1 + sc1[:, None]) + sh1[:, None]
        b, n, _ = x.shape

        def heads(y):
            return y.view(b, n, self.heads, -1).transpose(1, 2)

        q, k, v = heads(self.attn.to_q(norm)), heads(self.attn.to_k(norm)), heads(self.attn.to_v(norm))
        q = q * freqs.cos() + rotate_half(q) * freqs.sin()
        k = k * freqs.cos() + rotate_half(k) * freqs.sin()
        o = _BlockedAttention.apply(q, k, v, valid)
        o = self.attn.to_out[0](o.transpose(1, 2).reshape(b, n, -1))
        if attn_keep is not None:
            o = torch.where(attn_keep, o / (1.0 - self.p), torch.zeros((), device=o.device))
        x = x + g1[:, None] * mask_rows(o, valid)
        norm = F.layer_norm(x, x.shape[-1:], eps=LN_EPS) * (1 + sc2[:, None]) + sh2[:, None]
        hdn = self.ff.ff[0][1](self.ff.ff[0][0](norm))
        if ff_keep is not None:
            hdn = torch.where(ff_keep, hdn / (1.0 - self.p), torch.zeros((), device=hdn.device))
        return x + g2[:, None] * self.ff.ff[2](hdn)


class DiT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.time_embed = TimestepEmbedding(cfg["dim"], FREQ_EMBED_DIM)
        self.text_embed = TextEmbedding(cfg)
        self.input_embed = InputEmbedding(cfg)
        self.transformer_blocks = nn.ModuleList([DiTBlock(cfg) for _ in range(cfg["depth"])])
        self.norm_out = nn.Module()
        self.norm_out.linear = Linear(cfg["dim"], 2 * cfg["dim"], island=True)
        self.proj_out = Linear(cfg["dim"], cfg["n_feats"])

    def forward(self, x, cond, text, t, valid, drop_audio, gen):
        cfg = self.cfg
        temb = self.time_embed(t)
        h = self.input_embed(x, cond, text, valid, drop_audio)
        freqs = rotary(x.shape[1], cfg["dim_head"], x.device)
        hidden = cfg["dim"] * cfg["ff_mult"]
        for block in self.transformer_blocks:
            keeps = (None, None)
            if gen is not None:
                keeps = tuple(torch.rand((*x.shape[:2], width), generator=gen, device=x.device) < 1.0 - DROPOUT
                              for width in (cfg["dim"], hidden))
            if torch.is_grad_enabled():
                h = checkpoint(block, h, temb, valid, freqs, *keeps, use_reentrant=False)
            else:
                h = block(h, temb, valid, freqs, *keeps)
        sc, sh = torch.chunk(self.norm_out.linear(F.silu(temb)), 2, dim=1)
        return self.proj_out(F.layer_norm(h, h.shape[-1:], eps=LN_EPS) * (1 + sc)[:, None] + sh[:, None])


class F5TTS(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = dict(cfg)
        self.transformer = DiT(self.cfg)


def draws(lens, shape, gen):
    """λ, the span's start, x₀, t on ``gen`` → (span (B, N) bool, x₀, t)."""
    b, n, _ = shape
    dev = lens.device
    frac_lengths = torch.zeros((b,), device=dev).float().uniform_(*FRAC_LENGTHS, generator=gen)
    span_len = (frac_lengths * lens).long()
    start = ((lens - span_len) * torch.rand((b,), generator=gen, device=dev)).long().clamp(min=0)
    pos = torch.arange(n, device=dev)[None]
    span = (pos >= start[:, None]) & (pos < (start + span_len)[:, None]) & (pos < lens[:, None])
    x0 = torch.randn(tuple(shape), generator=gen, device=dev)
    return span, x0, torch.rand((b,), generator=gen, device=dev)


def losses(model: F5TTS, batch: dict, seed: int, step: int) -> dict:
    """The flow-matching loss of one padded batch (dict of x, x_lengths, y,
    y_lengths, weights on one device), and the step's drops."""
    cfg = model.cfg
    dev = batch["y"].device
    drop_audio, drop_text = drops(seed, step)
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    drop_gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step, 0, 2))
    x1 = batch["y"].float()
    b, n, c = x1.shape
    lens = batch["y_lengths"].long()
    w = batch["weights"].float()
    valid = torch.arange(n, device=dev)[None] < lens[:, None]
    span, x0, t = draws(lens, x1.shape, gen)
    tt = t[:, None, None]
    phi = (1 - tt) * x0 + tt * x1
    flow = x1 - x0
    cond = torch.where(span[..., None], torch.zeros_like(x1), x1)
    text = model.transformer.text_embed(batch["x"], batch["x_lengths"].long(), n, drop_text)
    pred = model.transformer(phi, cond, text, t, valid, drop_audio, drop_gen)
    weight = span.float() * w[:, None]
    loss = (F.mse_loss(pred, flow, reduction="none") * weight[..., None]).sum() / (weight.sum() * c)
    return {"loss": loss, "drop_audio": drop_audio, "drop_text": drop_text}


class AdamW:
    """Global-norm clip → AdamW with decay on every leaf, over a {name: tensor} dict."""

    def __init__(self, opt: dict, params: dict):
        self.o = opt
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        o = self.o
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        factor = torch.where(norm < o["grad_clip"], torch.ones_like(norm), o["grad_clip"] / norm)
        self.count += 1
        n = torch.tensor(float(self.count))
        bc1 = float(1.0 - torch.pow(torch.tensor(o["b1"], dtype=torch.float32), n))
        bc2 = float(1.0 - torch.pow(torch.tensor(o["b2"], dtype=torch.float32), n))
        for name, p in params.items():
            g = grads[name] * factor
            self.mu[name] = (1 - o["b1"]) * g + o["b1"] * self.mu[name]
            self.nu[name] = (1 - o["b2"]) * g * g + o["b2"] * self.nu[name]
            u = (self.mu[name] / bc1) / (torch.sqrt(self.nu[name] / bc2) + o["eps"])
            p.sub_(o["lr"] * (u + o["weight_decay"] * p))


def run_steps(cfg: dict, params: dict, batches: list[dict], seed: int, device) -> dict:
    """Train a copy of ``params`` on ``batches`` (one step each, steps 0, 1,
    ...) → each step's loss and drops, the first step's clipped gradient as
    the optimizer took it, and the parameters after the last step (on the
    CPU).  ``cfg``: a configuration file's dict, ``model`` and
    ``training.optimizer``.  TF32 stays off: every product is fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = F5TTS(cfg["model"]).to(device)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    live = dict(model.named_parameters())
    opt = AdamW(cfg["training"]["optimizer"], live)
    out = {"losses": [], "first_grad": None}
    for step, batch in enumerate(batches):
        batch = {k: v.to(device) for k, v in batch.items()}
        ls = losses(model, batch, seed, step)
        grads = torch.autograd.grad(ls["loss"], list(live.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(live.items(), grads)}
        opt.update(live, grads)
        out["losses"].append({"loss": float(ls["loss"].detach()), "drop_audio": ls["drop_audio"],
                              "drop_text": ls["drop_text"]})
        if step == 0:
            out["first_grad"] = {n: (m / (1 - opt.o["b1"])).cpu() for n, m in opt.mu.items()}
        del ls, grads
    out["params"] = {n: p.detach().cpu() for n, p in live.items()}
    return out
