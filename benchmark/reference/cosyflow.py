"""Plain fp32 CosyVoice 2 flow stage: its training step and Adam.

A stand-alone copy of the published flow-matching stage (arXiv:2412.10117;
FunAudioLLM/CosyVoice ``cosyvoice/flow/flow.py`` ``CausalMaskedDiffWithXvec``,
``cosyvoice/transformer/upsample_encoder.py``, ``encoder_layer.py``,
``attention.py``, ``embedding.py``, ``cosyvoice/flow/decoder.py``,
``cosyvoice/flow/flow_matching.py``; the yaml is
``examples/libritts/cosyvoice2/conf/cosyvoice2.yaml``) in plain ``torch``
operations, float32 throughout.  It imports nothing of the program it
judges, nor JAX.  Parameter names are the published checkpoint's, the
estimator's transformer blocks under diffusers' ``BasicTransformerBlock``
names, so one state_dict loads into this module and into the program
alike.  ``tests/plain_cosyflow.py`` and ``benchmark/reference/cosyflow.py``
are two copies of this file.

The configuration is a dict with the widths of the program's
``CosyFlowConfig``.  The relative positions are found by explicit (i, j)
indexing: score(i, j) adds (q_i + w)·p[T − 1 − i + j], the row of position
i − j; a streaming step's chunk masks are j < (⌊i/c⌋ + 1)·c over the (i, j)
grid.

Randomness, drawn exactly as the program draws it, with
``step_seed(seed, step, *more)`` = numpy's ``SeedSequence([seed, step,
*more])``'s first two 32-bit words.  On the host: the streaming flag, one
uniform from a CPU ``torch.Generator`` seeded from ``step_seed(seed, step,
0, 1)``, below 0.5; the rows' (3, B) uniforms from one seeded from
``step_seed(seed, step, 0, 3)``: the prompt on where the first ≥ 0.5, its
length ⌊u₂·(⌊0.3·T⌋ + 1)⌋ frames, the conditions kept where u₃ > 0.2.  On a
generator of the batch's device seeded from ``step_seed(seed, step)``: t
(B), then z (B, T, 80).  The dropout masks come from one seeded from
``step_seed(seed, step, 0, 2)``, as ``torch.rand(shape) < 1 − p``, in the
program's module order: each embedding's two masks on h and its mask on
the positions, then each layer's probability mask (B, H, T, T), attention
residual, FFN hidden and FFN residual masks.

Departures from the published code, all for the comparison:
  * fill rows (weight 0) left out of the loss's sum and count;
  * seeded generators in place of Python's ``random`` and the global RNG,
    and the x-vectors a fixed seeded table of unit rows (no CAM++);
  * the batch's tokens cut or padded to half its mel frames;
  * memory: each encoder layer, resnet and transformer block runs under
    ``torch.utils.checkpoint`` with its dropout masks drawn before it and
    passed in (the checkpoint restores only the default generator).  The
    numbers are those of the plain graph up to summation order.

``precision("fp8")`` rounds the inputs and weights of every product the
program computes in bfloat16 (every linear and conv but the estimator's
final projection) to float8 e4m3 with a per-tensor scale, and the
gradients through them to e5m2: the control, one precision below bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

STREAMING_PROB, PROMPT_PROB, PROMPT_TENTHS = 0.5, 0.5, 3
LEAKY_SLOPE = 0.01
XVECTOR_SEED = 192

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


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(quant(x), quant(self.weight), self.bias)


class Conv1d(nn.Conv1d):
    """Conv over time of (B, T, C), padded (left, right) frames first."""

    def __init__(self, cin, cout, k, pad=(0, 0), island=False):
        super().__init__(cin, cout, k)
        self.pad, self.island = pad, island

    def forward(self, x):
        x = F.pad(x.transpose(1, 2), self.pad)
        if self.island:
            return F.conv1d(x, self.weight, self.bias).transpose(1, 2)
        return F.conv1d(quant(x), quant(self.weight), self.bias).transpose(1, 2)


def drop(x, keep, p):
    return x if keep is None else torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def keep_mask(shape, p, gen, device):
    return None if gen is None else torch.rand(shape, generator=gen, device=device) < 1.0 - p


def positions(n: int, width: int, device):
    """(2n − 1, width): row m is position n − 1 − m, even columns
    sin(r·f_k), odd cos(r·f_k), f_k = exp(−2k·ln 10⁴ / width)."""
    r = torch.arange(n - 1, -n, -1, dtype=torch.float32, device=device)
    f = torch.exp(torch.arange(0, width, 2, dtype=torch.float32, device=device) * -(math.log(10000.0) / width))
    pe = torch.zeros((2 * n - 1, width), device=device)
    pe[:, 0::2] = torch.sin(r[:, None] * f)
    pe[:, 1::2] = torch.cos(r[:, None] * f)
    return pe


def visible(valid, t: int, chunk: int):
    """(B, 1, T, T): key j valid and, with a chunk c, j < (⌊i/c⌋ + 1)·c."""
    i = torch.arange(t, device=valid.device)[:, None]
    j = torch.arange(t, device=valid.device)[None, :]
    see = valid[:, None, None, :]
    return see & (j < (i // chunk + 1) * chunk) if chunk else see


class Embed(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.out = nn.ModuleList([Linear(d, d), nn.LayerNorm(d, eps=1e-5), nn.Identity()])


class RelAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.h, self.dk = heads, d // heads
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads))
        self.linear_q, self.linear_k, self.linear_v, self.linear_out = (Linear(d, d) for _ in range(4))
        self.linear_pos = Linear(d, d, bias=False)

    def forward(self, x, pos, see, p_keep, p):
        b, t, _ = x.shape

        def heads(y):
            return y.reshape(y.shape[0], -1, self.h, self.dk).transpose(1, 2)

        q, k, v = heads(self.linear_q(x)), heads(self.linear_k(x)), heads(self.linear_v(x))
        pp = heads(self.linear_pos(pos[None]))
        ac = (q + self.pos_bias_u[:, None]) @ k.transpose(-1, -2)
        full = (q + self.pos_bias_v[:, None]) @ pp.transpose(-1, -2)    # (B, H, T, 2T − 1)
        i = torch.arange(t, device=x.device)[:, None].expand(t, t)
        j = torch.arange(t, device=x.device)[None, :].expand(t, t)
        bd = full[:, :, i, t - 1 - i + j]                                # position i − j
        scores = ((ac + bd) / math.sqrt(self.dk)).masked_fill(~see, float("-inf"))
        attn = drop(torch.softmax(scores, dim=-1), p_keep, p)
        return self.linear_out((attn @ v).transpose(1, 2).reshape(b, t, -1))


class FFN(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.w_1, self.w_2 = Linear(d, hidden), Linear(hidden, d)


class Layer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["encoder_dim"]
        self.p = cfg["encoder_dropout"]
        self.self_attn = RelAttention(d, cfg["encoder_heads"])
        self.feed_forward = FFN(d, cfg["encoder_ffn"])
        self.norm_ff = nn.LayerNorm(d, eps=1e-12)
        self.norm_mha = nn.LayerNorm(d, eps=1e-12)

    def forward(self, h, pos, see, k_attn, k_res1, k_hid, k_res2):
        h = h + drop(self.self_attn(self.norm_mha(h), pos, see, k_attn, self.p), k_res1, self.p)
        ff = self.feed_forward
        hid = drop(F.silu(ff.w_1(self.norm_ff(h))), k_hid, self.p)
        return h + drop(ff.w_2(hid), k_res2, self.p)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["encoder_dim"]
        self.cfg = cfg
        self.embed = Embed(d)
        la = cfg["pre_lookahead"]
        self.pre_lookahead_layer = nn.Module()
        self.pre_lookahead_layer.conv1 = Conv1d(d, d, la + 1, pad=(0, la))
        self.pre_lookahead_layer.conv2 = Conv1d(d, d, 3, pad=(2, 0))
        self.encoders = nn.ModuleList(Layer(cfg) for _ in range(cfg["encoder_layers"]))
        r = cfg["token_mel_ratio"]
        self.up_layer = nn.Module()
        self.up_layer.conv = Conv1d(d, d, 2 * r + 1, pad=(2 * r, 0))
        self.up_embed = Embed(d)
        self.up_encoders = nn.ModuleList(Layer(cfg) for _ in range(cfg["up_layers"]))
        self.after_norm = nn.LayerNorm(d, eps=1e-5)

    def _embed(self, emb, x, gen):
        p, (b, t, d) = self.cfg["encoder_dropout"], x.shape
        h = drop(emb.out[1](emb.out[0](x)), keep_mask((b, t, d), p, gen, x.device), p) * math.sqrt(d)
        h = drop(h, keep_mask((b, t, d), p, gen, x.device), p)
        return h, drop(positions(t, d, x.device), keep_mask((2 * t - 1, d), p, gen, x.device), p)

    def _layers(self, layers, h, valid, pos, chunk, gen):
        cfg, p = self.cfg, self.cfg["encoder_dropout"]
        b, t, d = h.shape
        see = visible(valid, t, chunk)
        for layer in layers:
            keeps = (keep_mask((b, cfg["encoder_heads"], t, t), p, gen, h.device),
                     keep_mask((b, t, d), p, gen, h.device),
                     keep_mask((b, t, cfg["encoder_ffn"]), p, gen, h.device),
                     keep_mask((b, t, d), p, gen, h.device))
            h = checkpoint(layer, h, pos, see, *keeps, use_reentrant=False) if torch.is_grad_enabled() \
                else layer(h, pos, see, *keeps)
        return h

    def forward(self, x, tok_valid, chunks, gen):
        r = self.cfg["token_mel_ratio"]
        h, pos = self._embed(self.embed, x, gen)
        la = self.pre_lookahead_layer
        h = h + la.conv2(F.leaky_relu(la.conv1(h), LEAKY_SLOPE))
        h = self._layers(self.encoders, h, tok_valid, pos, chunks[0], gen)
        h = self.up_layer.conv(h.repeat_interleave(r, dim=1))
        h, pos = self._embed(self.up_embed, h, gen)
        h = self._layers(self.up_encoders, h, tok_valid.repeat_interleave(r, dim=1), pos, chunks[1], gen)
        return self.after_norm(h)


class CausalBlock(nn.Module):
    """conv3 padded 2 on the left → LayerNorm over channels → Mish, masked."""

    def __init__(self, cin, cout):
        super().__init__()
        self.block = nn.ModuleList([Conv1d(cin, cout, 3, pad=(2, 0)), nn.Identity(), nn.LayerNorm(cout)])

    def forward(self, x, m):
        return F.mish(self.block[2](self.block[0](x * m))) * m


class Resnet(nn.Module):
    def __init__(self, cin, cout, ted):
        super().__init__()
        self.mlp = nn.ModuleList([nn.Mish(), Linear(ted, cout)])
        self.block1, self.block2 = CausalBlock(cin, cout), CausalBlock(cout, cout)
        self.res_conv = Conv1d(cin, cout, 1)

    def forward(self, x, m, temb):
        h = self.block1(x, m) + self.mlp[1](F.mish(temb))[:, None]
        return self.block2(h, m) + self.res_conv(x * m)


class TBlock(nn.Module):
    """diffusers' BasicTransformerBlock: LN → attention (q, k, v without
    bias) → LN → Linear → exact GELU → Linear, residual both."""

    def __init__(self, d, heads, dh):
        super().__init__()
        self.heads = heads
        self.norm1, self.norm3 = nn.LayerNorm(d), nn.LayerNorm(d)
        self.attn1 = nn.Module()
        self.attn1.to_q, self.attn1.to_k, self.attn1.to_v = (Linear(d, heads * dh, bias=False) for _ in range(3))
        self.attn1.to_out = nn.ModuleList([Linear(heads * dh, d)])
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([nn.Module(), nn.Identity(), Linear(4 * d, d)])
        self.ff.net[0].proj = Linear(d, 4 * d)

    def forward(self, x, see):
        b, t, _ = x.shape
        a = self.norm1(x)

        def heads(y):
            return y.reshape(b, t, self.heads, -1).transpose(1, 2)

        q, k, v = heads(self.attn1.to_q(a)), heads(self.attn1.to_k(a)), heads(self.attn1.to_v(a))
        s = (q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])).masked_fill(~see, float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, t, -1)
        x = x + self.attn1.to_out[0](o)
        return x + self.ff.net[2](F.gelu(self.ff.net[0].proj(self.norm3(x))))


class Estimator(nn.Module):
    """``CausalConditionalDecoder`` with one level (channels [c])."""

    def __init__(self, cfg):
        super().__init__()
        cin, c = 4 * cfg["n_feats"], cfg["estimator_channels"][0]
        ted = 4 * c
        self.cin = cin
        self.time_mlp = nn.Module()
        self.time_mlp.linear_1, self.time_mlp.linear_2 = Linear(cin, ted), Linear(ted, ted)

        def blocks():
            return nn.ModuleList(TBlock(c, cfg["estimator_heads"], cfg["estimator_head_dim"])
                                 for _ in range(cfg["estimator_blocks"]))

        self.down_blocks = nn.ModuleList([nn.ModuleList([Resnet(cin, c, ted), blocks(), Conv1d(c, c, 3, pad=(2, 0))])])
        self.mid_blocks = nn.ModuleList(nn.ModuleList([Resnet(c, c, ted), blocks()])
                                        for _ in range(cfg["estimator_mid"]))
        self.up_blocks = nn.ModuleList([nn.ModuleList([Resnet(2 * c, c, ted), blocks(), Conv1d(c, c, 3, pad=(2, 0))])])
        self.final_block = CausalBlock(c, c)
        self.final_proj = Conv1d(c, cfg["n_feats"], 1, island=True)

    def forward(self, x, mask, cond, t, chunk):
        half = self.cin // 2  # SinusoidalPosEmb(in_channels), scale 1000
        f = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -(math.log(10000.0) / (half - 1)))
        arg = 1000.0 * t[:, None] * f[None]
        temb = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
        temb = self.time_mlp.linear_2(F.silu(self.time_mlp.linear_1(temb)))
        m = mask[..., None]
        see = visible(mask > 0, x.shape[1], chunk)

        def run(module, *args):
            return checkpoint(module, *args, use_reentrant=False) if torch.is_grad_enabled() else module(*args)

        h = torch.cat([x, cond], dim=-1)
        resnet, tblocks, last = self.down_blocks[0]
        h = run(resnet, h, m, temb)
        for blk in tblocks:
            h = run(blk, h, see)
        skip = h
        h = last(h * m)
        for resnet, tblocks in self.mid_blocks:
            h = run(resnet, h, m, temb)
            for blk in tblocks:
                h = run(blk, h, see)
        resnet, tblocks, last = self.up_blocks[0]
        h = run(resnet, torch.cat([h, skip], dim=-1), m, temb)
        for blk in tblocks:
            h = run(blk, h, see)
        h = self.final_block(last(h * m), m)
        return self.final_proj(h * m) * m


class CosyFlow(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = dict(cfg)
        self.input_embedding = nn.Embedding(cfg["vocab_size"], cfg["encoder_dim"])
        self.spk_embed_affine_layer = Linear(cfg["spk_embed_dim"], cfg["n_feats"])
        self.encoder = Encoder(self.cfg)
        self.encoder_proj = Linear(cfg["encoder_dim"], cfg["n_feats"])
        self.decoder = nn.Module()
        self.decoder.estimator = Estimator(self.cfg)
        e = torch.randn((cfg["n_xvectors"], cfg["spk_embed_dim"]),
                        generator=torch.Generator().manual_seed(XVECTOR_SEED), device="cpu")
        self.register_buffer("xvectors", e / e.norm(dim=1, keepdim=True).clamp(min=1e-12), persistent=False)


def draws(seed: int, step: int, b: int) -> tuple[bool, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(streaming, prompt on (B,), prompt-length uniforms (B,), kept (B,)) on the host."""
    s = torch.rand((1,), generator=torch.Generator().manual_seed(step_seed(seed, step, 0, 1)))
    u = torch.rand((3, b), generator=torch.Generator().manual_seed(step_seed(seed, step, 0, 3)))
    return bool(s[0] < STREAMING_PROB), u[0] >= 1.0 - PROMPT_PROB, u[1], u[2] > 0.2


def losses(model: CosyFlow, batch: dict, seed: int, step: int, streaming: bool | None = None) -> dict:
    """The flow-matching loss of one padded batch (dict of x, x_lengths, y,
    y_lengths, spks, weights on one device) and the step's draws;
    ``streaming`` overrides the drawn flag."""
    cfg = model.cfg
    dev = batch["y"].device
    x1 = batch["y"].float()
    b, n, c = x1.shape
    drawn_streaming, prompt_on, prompt_u, kept = draws(seed, step, b)
    streaming = drawn_streaming if streaming is None else streaming
    chunks = (cfg["chunk"], cfg["chunk"] * cfg["token_mel_ratio"]) if streaming else (0, 0)
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    drop_gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step, 0, 2))
    n_tok = n // cfg["token_mel_ratio"]
    x = batch["x"].long()
    tokens = x[:, :n_tok] if x.shape[1] >= n_tok else F.pad(x, (0, n_tok - x.shape[1]))
    tok_valid = torch.arange(n_tok, device=dev)[None] < batch["x_lengths"].long()[:, None]
    h = model.input_embedding(tokens) * tok_valid[..., None]
    mu = model.encoder_proj(model.encoder(h, tok_valid, chunks, drop_gen))
    t = torch.rand((b,), generator=gen, device=dev)
    t = 1.0 - torch.cos(t * (0.5 * math.pi))
    z = torch.randn((b, n, c), generator=gen, device=dev)
    sigma = cfg["sigma_min"]
    tt = t[:, None, None]
    y = (1 - (1 - sigma) * tt) * z + tt * x1
    u = x1 - (1 - sigma) * z
    lens = batch["y_lengths"].long()
    prompt_on, prompt_u, kept = (v.to(dev) for v in (prompt_on, prompt_u, kept))
    n_prompt = (prompt_u * ((PROMPT_TENTHS * lens) // 10 + 1)).long() * prompt_on
    pos = torch.arange(n, device=dev)[None]
    cond = x1 * (pos < n_prompt[:, None])[..., None]
    keep = kept.float()[:, None, None]
    xv = model.xvectors[batch["spks"].long()]
    spk = model.spk_embed_affine_layer(xv / xv.norm(dim=1, keepdim=True).clamp(min=1e-12))
    conds = torch.cat([mu * keep, (spk[:, None] * keep).expand(b, n, c), cond * keep], dim=-1)
    mask = (pos < lens[:, None]).float()
    pred = model.decoder.estimator(y, mask, conds, t, chunks[1])
    weight = mask * batch["weights"].float()[:, None]
    loss = ((pred - u).square().sum(-1) * weight).sum() / (weight.sum() * c)
    return {"loss": loss, "streaming": streaming, "prompted": int(prompt_on.sum()), "dropped": int((~kept).sum())}


class Adam:
    """Global-norm clip → AdamW (decay added to the update) over a {name: tensor} dict."""

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
            upd = (self.mu[name] / bc1) / (torch.sqrt(self.nu[name] / bc2) + o["eps"])
            p.sub_(o["lr"] * (upd + o["weight_decay"] * p))


def run_steps(cfg: dict, params: dict, batches: list[dict], seed: int, device) -> dict:
    """Train a copy of ``params`` on ``batches`` (one step each, steps 0, 1,
    ...) → each step's loss and draws, the first step's clipped gradient
    as the optimizer took it, and the parameters after the last step (on
    the CPU).  ``cfg``: a configuration file's dict, ``model`` and
    ``training.optimizer``.  TF32 stays off: every product is fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CosyFlow(cfg["model"]).to(device)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    live = dict(model.named_parameters())
    opt = Adam(cfg["training"]["optimizer"], live)
    out = {"losses": [], "first_grad": None}
    for step, batch in enumerate(batches):
        batch = {k: v.to(device) for k, v in batch.items()}
        ls = losses(model, batch, seed, step)
        grads = torch.autograd.grad(ls["loss"], list(live.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(live.items(), grads)}
        opt.update(live, grads)
        out["losses"].append({**ls, "loss": float(ls["loss"].detach())})
        if step == 0:
            out["first_grad"] = {n: (m / (1 - opt.o["b1"])).cpu() for n, m in opt.mu.items()}
        del ls, grads
    out["params"] = {n: p.detach().cpu() for n, p in live.items()}
    return out
