"""F5-TTS's DiT and its flow-matching training forward.

The port's second model (arXiv:2410.06885; SWivid/F5-TTS
``src/f5_tts/model/backbones/dit.py``, ``model/modules.py``,
``model/cfm.py``), at ``DiTConfig``'s widths.  The JAX package has no
counterpart.  Parameter names are the published checkpoint's under
``transformer.``, so a state_dict of one loads into the other.

Layout: activations (B, N, C), N the batch's padded mel length; ``mask``
(B, N) is true on a row's real frames.

  time      s = [sin(1000·t·f), cos(1000·t·f)], f_k = exp(−k·ln 10⁴/127);
            temb = Linear(SiLU(Linear(s)))
  text      ids + 1 (0 the filler) cut or padded to N; all 0 under a text
            drop; Embedding + sinusoidal positions cat(cos pθ, sin pθ);
            filler positions zeroed, then ConvNeXt-V2 blocks (dwconv k7 →
            LN ε 1e-6 → Linear → GELU → GRN → Linear, residual), the filler
            zeroed after each
  input     h = Linear(cat(x_t, cond, text)) (cond 0 under an audio drop);
            h ← h + P(h), P two grouped conv k31 → Mish, masked positions
            zeroed before and after
  blocks    adaLN-zero: (sh₁, sc₁, g₁, sh₂, sc₂, g₂) = Linear(SiLU(temb));
            h ← h + g₁·zero_pad(dropout(W_o·attn(RoPE(q), RoPE(k), v)))
            with a = LN₀(h)(1+sc₁)+sh₁ feeding q, k, v; then
            h ← h + g₂·W₂·dropout(GELU_tanh(W₁·(LN₀(h)(1+sc₂)+sh₂)))
  output    (sc, sh) = Linear(SiLU(temb)); out = Linear(LN₀(h)(1+sc)+sh)

LN₀ is LayerNorm without affine, ε 1e-6.  RoPE rotates interleaved pairs
(x₂ᵢ, x₂ᵢ₊₁) of every head's 64 dims by positions 0…N−1 at inverse
frequencies 10000^(−2i/64), the x-transformers convention F5 uses.
Attention is softmax(q·kᵀ/8) over the valid keys (``ops/attention.py``:
K1 and K1b on the card, the plain version on the CPU).  The blocks' glue
(modulate, RoPE with the head layout, the gated residual with its dropout
and row mask, GELU with its dropout) is ``ops/dit_fused.py``'s four ops,
which choose by device as attention does: hand-written kernels with their
own backwards on the card, their plain versions on the CPU.

Training forward (``F5TTS.compute_losses``, ``cfm.py``'s ``forward``):
a span of ⌊λ·len⌋ frames, λ ~ U(0.7, 1), starting at ⌊U·(len − span)⌋,
is masked in each row; x₀ ~ N(0, I), t ~ U(0, 1) per row; x_t = (1−t)x₀ +
t·x₁; cond = x₁ with the span zeroed; the loss is the MSE of the predicted
flow against x₁ − x₀ over the span's elements, fill rows (weight 0) out of
both sum and count.  The drops (audio with p 0.3, or text and audio with
p 0.2) hold for the whole batch and are decided on the host
(``drop_audio``, ``drop_text``; ``guidance_drops``, which the training step
calls through ``F5TTS.step_kwargs``).

Order of the draws: first the drops, two uniforms from a CPU generator
seeded from ``step_seed(seed, step, 0, 1)``; on ``generator`` (the batch's
device; the step seeds it from ``step_seed(seed, step)``) λ (B), the span's
start U (B), x₀ (B, N, C), t (B), in that order; on the dropout generator
(``step_seed(seed, step, 0, 2)``: ``DROPOUT_WORDS`` keeps it apart from
the step's draws), in module order, each block's attention-output mask (B,
N, dim) then its FFN-hidden mask (B, N, ff_mult·dim), as
``layers.dropout`` draws them.

Precision: products (linears and convs) take their inputs in
``compute_dtype`` with fp32 accumulation; LayerNorm statistics, GRN, the
time embedding, the adaLN vectors, RoPE and the residual carry are fp32.
The loss is fp32.  The glue rounds to ``compute_dtype`` only where a
product takes its input, on every device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.config import DiTConfig
from matcha_tpu_torch.models.layers import (
    Conv1d, LayerNorm, Linear, compute_dtype, random_state_dict, sinusoidal_time_embedding, step_seed,
)
from matcha_tpu_torch.ops import dit_fused
from matcha_tpu_torch.ops.attention import masked_self_attention
from matcha_tpu_torch.utils.model_math import sequence_mask
from matcha_tpu_torch.utils.profiling import annotate

LN_EPS = 1e-6
# F5-TTS's module defaults, which its yaml leaves as they are (modules.py, dit.py, cfm.py)
CONV_MULT = 2                      # the text ConvNeXt's hidden width, in units of text_dim
FREQ_EMBED_DIM = 256               # the time step's sinusoidal features
CONV_POS_KERNEL, CONV_POS_GROUPS = 31, 16
DROPOUT = 0.1
FRAC_LENGTHS = (0.7, 1.0)          # the infilled span's share of a row
AUDIO_DROP_PROB, COND_DROP_PROB = 0.3, 0.2  # guidance: the audio dropped; text and audio dropped
DROP_WORDS = (0, 1)  # after (seed, step): the stream of the guidance drops

_TABLES: dict = {}  # (kind, width, N, device) → a fixed position table


def _table(kind: str, width: int, n: int, device) -> torch.Tensor:
    """The text's sinusoidal positions (N, width), or RoPE's (cos, sin) of
    each pair (N, width/2) stacked last, fp32; made once per shape."""
    key = (kind, width, n, str(device))
    if key not in _TABLES:
        pos = torch.arange(n, dtype=torch.float32, device=device)
        inv = 1.0 / (10000.0 ** (torch.arange(0, width, 2, device=device)[: width // 2].float() / width))
        ang = torch.outer(pos, inv)
        if kind == "text":
            _TABLES[key] = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        else:
            _TABLES[key] = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    return _TABLES[key]


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # indices 0 and 2 as the published Sequential(Linear, SiLU, Linear)
        self.time_mlp = nn.ModuleList([Linear(FREQ_EMBED_DIM, dim), nn.SiLU(), Linear(dim, dim)])

    def forward(self, t):
        s = sinusoidal_time_embedding(t.float(), FREQ_EMBED_DIM)
        return self.time_mlp[2](F.silu(self.time_mlp[0](s)))


class GRN(nn.Module):
    """Global response normalisation over the time axis (ConvNeXt-V2), fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x):
        x = x.float()
        gx = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.pwconv1 = Linear(dim, hidden, dtype=dtype)
        self.grn = GRN(hidden)
        self.pwconv2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        y = self.norm(self.dwconv(x))
        y = self.grn(F.gelu(self.pwconv1(y)))
        return x + self.pwconv2(y).float()


class TextEmbedding(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        self.text_dim = cfg.text_dim
        self.text_embed = nn.Embedding(cfg.n_vocab + 1, cfg.text_dim)  # row 0 the filler
        self.text_blocks = nn.ModuleList([ConvNeXtV2Block(cfg.text_dim, cfg.text_dim * CONV_MULT, dtype)
                                          for _ in range(cfg.conv_layers)])

    def forward(self, x, x_lengths, n: int, drop_text: bool = False):
        """(B, Tx) ids → (B, N, text_dim) fp32."""
        tx = x.shape[1]
        ids = x[:, :n] if tx >= n else F.pad(x, (0, n - tx))
        keep = sequence_mask(x_lengths, n)[..., None]
        ids = torch.zeros_like(ids) if drop_text else torch.where(keep[..., 0], ids.long() + 1, 0)
        e = self.text_embed(ids) + _table("text", self.text_dim, n, x.device)
        e = e.masked_fill(~keep, 0.0)
        for block in self.text_blocks:
            e = block(e).masked_fill(~keep, 0.0)
        return e


class ConvPositionEmbedding(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()

        def conv():
            return Conv1d(dim, dim, CONV_POS_KERNEL, padding=CONV_POS_KERNEL // 2, groups=CONV_POS_GROUPS, dtype=dtype)

        self.conv1d = nn.ModuleList([conv(), nn.Mish(), conv(), nn.Mish()])

    def forward(self, x, keep):
        x = x.masked_fill(~keep, 0.0)
        x = F.mish(self.conv1d[2](F.mish(self.conv1d[0](x))))
        return x.masked_fill(~keep, 0.0)


class InputEmbedding(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        self.proj = Linear(2 * cfg.n_feats + cfg.text_dim, cfg.dim, dtype=dtype)
        self.conv_pos_embed = ConvPositionEmbedding(cfg.dim, dtype)

    def forward(self, xt, cond, text, keep, drop_audio: bool = False):
        if drop_audio:
            cond = torch.zeros_like(cond)
        h = self.proj(torch.cat([xt, cond, text], dim=-1)).float()
        return h + self.conv_pos_embed(h, keep).float()


class AdaLayerNorm(nn.Module):
    """The block's six modulation vectors from the time embedding, fp32;
    ``norm`` (LN₀) has no parameters."""

    def __init__(self, dim: int, chunks: int):
        super().__init__()
        self.chunks = chunks
        self.linear = Linear(dim, dim * chunks)

    def forward(self, temb_act):
        return self.linear(temb_act)[:, None].chunk(self.chunks, dim=-1)


class Attention(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        inner = cfg.heads * cfg.dim_head
        self.heads = cfg.heads
        self.to_q = Linear(cfg.dim, inner, dtype=dtype)
        self.to_k = Linear(cfg.dim, inner, dtype=dtype)
        self.to_v = Linear(cfg.dim, inner, dtype=dtype)
        # index 1 holds the published Dropout; it has no weights
        self.to_out = nn.ModuleList([Linear(inner, cfg.dim, dtype=dtype), nn.Identity()])

    def forward(self, a, keep, rope):
        """W_o·attn(RoPE(q), RoPE(k), v), before the branch's dropout."""
        b, n, _ = a.shape
        q, k, v = dit_fused.rope_heads(self.to_q(a), self.to_k(a), self.to_v(a), rope, self.heads)
        o = masked_self_attention(q, k, v, keep[..., 0])
        return self.to_out[0](o.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        hidden = cfg.dim * cfg.ff_mult
        # the published ff = Sequential(Sequential(Linear, GELU), Dropout, Linear)
        self.ff = nn.ModuleList([nn.ModuleList([Linear(cfg.dim, hidden, dtype=dtype), nn.GELU("tanh")]),
                                 nn.Identity(), Linear(hidden, cfg.dim, dtype=dtype)])

    def forward(self, f, gen):
        return self.ff[2](dit_fused.gelu_dropout(self.ff[0][0](f), DROPOUT, gen))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype):
        super().__init__()
        self.dtype = dtype
        self.attn_norm = AdaLayerNorm(cfg.dim, 6)
        self.attn = Attention(cfg, dtype)
        self.ff = FeedForward(cfg, dtype)

    def forward(self, h, temb_act, keep, rope, gen):
        sh1, sc1, g1, sh2, sc2, g2 = self.attn_norm(temb_act)
        o = self.attn(dit_fused.modulate(h, sc1, sh1, self.dtype, LN_EPS, "attn"), keep, rope)
        h = dit_fused.gated_residual(h, g1, o, DROPOUT, gen, keep[..., 0], "attn")
        f = self.ff(dit_fused.modulate(h, sc2, sh2, self.dtype, LN_EPS, "ff"), gen)
        return dit_fused.gated_residual(h, g2, f, 0.0, None, None, "ff")


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        dtype = compute_dtype(cfg.compute_dtype)
        self.cfg, self.dtype = cfg, dtype
        self.time_embed = TimestepEmbedding(cfg.dim)
        self.text_embed = TextEmbedding(cfg, dtype)
        self.input_embed = InputEmbedding(cfg, dtype)
        self.transformer_blocks = nn.ModuleList([DiTBlock(cfg, dtype) for _ in range(cfg.depth)])
        self.norm_out = AdaLayerNorm(cfg.dim, 2)
        self.proj_out = Linear(cfg.dim, cfg.n_feats, dtype=dtype)

    def forward(self, xt, cond, text, t, keep, drop_audio: bool = False, gen=None):
        """The predicted flow (B, N, n_feats) fp32; ``keep`` (B, N, 1) bool."""
        temb_act = F.silu(self.time_embed(t))
        h = self.input_embed(xt, cond, text, keep, drop_audio)
        rope = _table("rope", self.cfg.dim_head, xt.shape[1], xt.device)
        for block in self.transformer_blocks:
            h = block(h, temb_act, keep, rope, gen)
        sc, sh = self.norm_out(temb_act)
        return self.proj_out(dit_fused.modulate(h, sc, sh, self.dtype, LN_EPS, "out")).float()


def cfm_draws(lengths, shape: tuple[int, int, int], generator):
    """A step's draws on ``generator``, in order: λ and the span's start,
    giving each row's span (B, N) bool (``cfm.py``'s
    ``mask_from_frac_lengths``), then x₀ (B, N, C), then t (B)."""
    b, n, _ = shape
    dev = lengths.device
    lam = torch.empty((b,), dtype=torch.float32, device=dev).uniform_(*FRAC_LENGTHS, generator=generator)
    span = (lam * lengths).long()
    start = ((lengths - span) * torch.rand((b,), generator=generator, device=dev)).long().clamp(min=0)
    pos = torch.arange(n, device=dev)
    mask = (pos[None] >= start[:, None]) & (pos[None] < (start + span)[:, None])
    x0 = torch.randn(shape, generator=generator, device=dev)
    return mask, x0, torch.rand((b,), generator=generator, device=dev)


def guidance_drops(seed: int, step: int) -> tuple[bool, bool]:
    """(drop the audio condition, drop the text) of step ``step``: two
    uniforms on the host; text and audio both with ``COND_DROP_PROB``,
    else the audio alone with ``AUDIO_DROP_PROB``."""
    u = torch.rand((2,), generator=torch.Generator().manual_seed(step_seed(seed, step, *DROP_WORDS)))
    both = bool(u[1] < COND_DROP_PROB)
    return bool(u[0] < AUDIO_DROP_PROB) or both, both


class F5TTS(nn.Module):
    """The DiT under ``transformer``, as ``cfm.py``'s CFM holds it."""

    # what ``train/step.py`` asks of the model class (as of ``matcha.MatchaTTS``):
    # (key of compute_losses' result, name among the step's metrics)
    METRICS = (("loss", "loss"),)
    PARALLEL = False     # data and tensor parallelism are not ported for the DiT
    DROPOUT_WORDS = (2,)  # after (seed, step, rank): the dropout masks apart from the step's draws

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = DiT(cfg)
        self.dropped = {"audio": 0, "text": 0}  # training steps with the condition dropped

    @staticmethod
    def init_params(cfg: DiTConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The module's ``init_params``."""
        return init_params(cfg, generator)

    @staticmethod
    def param_table(cfg: DiTConfig) -> list[tuple[str, str, str]]:
        """(torch name, tree path, "torch") for every parameter: the DiT has
        no flax layout, so its checkpoint tree nests the torch names by their
        dots; every leaf decays (``weights.decay_mask``), as
        ``torch.optim.AdamW`` over ``model.parameters()`` does in F5-TTS's
        trainer."""
        with torch.device("meta"):
            names = list(F5TTS(cfg).state_dict())
        return [(name, name.replace(".", "/"), "torch") for name in names]

    @staticmethod
    def batch_inputs(batch) -> tuple:
        """The fields of a ``train.step.Batch`` that ``compute_losses`` takes, in order."""
        return batch.x, batch.x_lengths, batch.y, batch.y_lengths

    def step_kwargs(self, seed: int, step: int, count: bool) -> dict:
        """The guidance drops of step ``step`` as ``compute_losses`` keywords,
        counted in ``dropped`` where ``count``."""
        audio, text = guidance_drops(seed, step)
        if count:
            self.dropped["audio"] += audio
            self.dropped["text"] += text
        return {"drop_audio": audio, "drop_text": text}

    def forward(self, *args, **kwargs):
        return self.compute_losses(*args, **kwargs)

    def compute_losses(self, x, x_lengths, y, y_lengths, generator: torch.Generator, *,
                       drop_audio: bool = False, drop_text: bool = False, row_weights=None,
                       dropout_generator: torch.Generator | None = None, deterministic: bool = False):
        """The flow-matching loss of one padded batch: x (B, Tx) ids, y (B,
        N, n_feats) mel, lengths (B,).  ``generator`` draws the span, x₀ and
        t; ``dropout_generator`` the dropout masks (``generator`` if None;
        ``deterministic`` turns dropout off).  ``row_weights`` (B,) weight
        each row (0 for fill rows)."""
        b, n, c = y.shape
        dev = y.device
        w = torch.ones((b,), dtype=torch.float32, device=dev) if row_weights is None else row_weights.float()
        keep = sequence_mask(y_lengths, n)[..., None]
        drop = None if deterministic else dropout_generator if dropout_generator is not None else generator
        with annotate("matcha/train.cfm"):
            span, x0, t = cfm_draws(y_lengths.long(), (b, n, c), generator)
            x1 = y.float()
            t3 = t[:, None, None]
            xt = (1.0 - t3) * x0 + t3 * x1
            cond = x1.masked_fill(span[..., None], 0.0)
        with annotate("matcha/train.text_embed"):
            text = self.transformer.text_embed(x, x_lengths, n, drop_text)
        with annotate("matcha/train.dit"):
            pred = self.transformer(xt, cond, text, t, keep, drop_audio, drop)
        with annotate("matcha/train.cfm"):
            weight = span * w[:, None]
            loss = ((pred - (x1 - x0)).square().sum(-1) * weight).sum() / (weight.sum() * c)
        return {"loss": loss}


def init_params(cfg: DiTConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random F5TTS state_dict (CPU, fp32), by ``layers.random_state_dict``'s
    rule: matrices and kernels normal, std 1/sqrt(fan-in); norm scales and
    GRN's gamma one; biases and GRN's beta zero."""
    with torch.device("meta"):
        model = F5TTS(cfg)
    return random_state_dict(model, generator)
