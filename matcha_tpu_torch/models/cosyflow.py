"""CosyVoice 2's streaming flow-matching stage and its training forward.

The port's third model (arXiv:2412.10117; FunAudioLLM/CosyVoice
``cosyvoice/flow/flow.py`` ``CausalMaskedDiffWithXvec``,
``cosyvoice/transformer/upsample_encoder.py``, ``cosyvoice/flow/decoder.py``
``CausalConditionalDecoder``, ``cosyvoice/flow/flow_matching.py``
``CausalConditionalCFM``), at ``CosyFlowConfig``'s widths.  The JAX package
has no counterpart.  Parameter names are the published checkpoint's
(``flow.pt``), but for the estimator's transformer blocks, which are the
port's ``DecoderTransformerBlock`` (diffusers' ``BasicTransformerBlock``
names: ``attn1.to_q`` …, ``ff.net.0.proj``).

Layout: activations (B, T, C).  A row holds L speech tokens (ids below
6,561, 25 Hz) and a mel of T = 2L frames (80 bands, 50 Hz); the batch's
tokens are cut or padded to T/2.

  tokens   h = Emb(s)·m_tok
  embed    h = Drop(Drop(LN(Linear(h)))·√512); the positions L−1 … −(L−1)
           as ESPnet's sinusoids (even columns sin, odd cos), Drop(P)
  lookahead  y = LeakyReLU(Conv_k4(h padded 3 on the right));
           h ← h + Conv_k3(y padded 2 on the left)
  6 layers h ← h + Drop(RelMHA(LN(h), P)), h ← h + Drop(W₂ Drop(Swish(W₁ LN(h))))
  upsample nearest ×2, 4 frames of zeros on the left, Conv_k5
  up_embed and 4 more layers at T frames, then LN; μ = Linear(h) (80)
  speaker  e′ = Linear(e / ‖e‖), e the row's x-vector
  CFM      t ~ U(0, 1) → 1 − cos(πt/2); z ~ N(0, I);
           y = (1 − (1 − σ)t)·z + t·x₁, target u = x₁ − (1 − σ)·z
  prompt   half the rows get cond[:, :n] = x₁[:, :n], n ~ U{0 … ⌊0.3·T_row⌋}
  guidance 20 % of the rows get μ, e′ and cond zeroed
  estimator  the causal U-Net (``decoder.Decoder(..., causal=True)``) on
           [y, μ, e′ over T, cond] (320 channels) at t
  loss     Σ mask·(v̂ − u)² / (80·Σ mask) over the valid frames of the
           real rows (fill rows, weight 0, out of both)

RelMHA is ``ops/relpos.relpos_attention``: [(q + u)·k + (q + w)·p_(i−j)]/8
over the keys a query sees.  A streaming step (with probability 0.5 for
the whole batch) makes every attention chunk-causal: 25 tokens in the
first six layers, 50 frames after the upsampling and in the estimator
(whose blocks run K1/K1b, ``ops/attention.py``, with that chunk).  As in
the source, padded tokens are not zeroed after the embedding, so the
lookahead of a row's last three tokens reads the padding's embedding.

Draws.  On the host: the step's streaming flag, one uniform from a CPU
generator seeded from ``step_seed(seed, step, 0, 1)`` (``STREAM_WORDS``),
streaming when it is below 0.5; then the rows' draws, 3·B uniforms from
one seeded from ``step_seed(seed, step, 0, 3)`` (``ROW_WORDS``): B for the
prompt (on where ≥ 0.5, as the source's ``random() < 0.5: continue``), B
for its length (n = ⌊u·(⌊0.3·T⌋ + 1)⌋, ⌊0.3·T⌋ as (3·T) // 10), B for the
guidance (kept where > 0.2).  On ``generator`` (the batch's device, seeded
from ``step_seed(seed, step)``): t (B), then z (B, T, 80).  On the dropout
generator (``step_seed(seed, step, 0, 2)``: ``DROPOUT_WORDS``), in module
order, as ``layers.dropout`` draws them: embed's two masks on h and its
mask on P, then each layer's probability mask (B, H, L, L), its attention
residual, FFN hidden and FFN residual masks; the same for up_embed and the
up layers.  The estimator has no dropout.  ``drawn`` counts the training
steps that were streaming, and the rows prompted and dropped.

Precision: products (linears and convs) take their inputs in
``compute_dtype`` with fp32 accumulation; the residual streams, LayerNorm
statistics, the attention's scores and softmax statistics, the time
embedding and the loss are fp32 (the estimator's own rule:
``DecoderConfig.fp32_residual``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.config import CosyFlowConfig, DecoderConfig
from matcha_tpu_torch.models.decoder import Decoder
from matcha_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, compute_dtype, dropout, random_state_dict, step_seed
from matcha_tpu_torch.ops.relpos import relpos_attention
from matcha_tpu_torch.utils.model_math import sequence_mask
from matcha_tpu_torch.utils.profiling import annotate

# flow.py's draws, which its yaml leaves as they are
STREAMING_PROB = 0.5   # steps trained chunk-causal
PROMPT_PROB = 0.5      # rows given a mel prompt
PROMPT_TENTHS = 3      # its longest: ⌊0.3·T⌋ frames of the row
STREAM_WORDS = (0, 1)  # after (seed, step): the streaming draw
ROW_WORDS = (0, 3)     # after (seed, step): the rows' prompt and guidance draws
LEAKY_SLOPE = 0.01     # torch's LeakyReLU default, which the lookahead layer takes
ATTN_LN_EPS = 1e-12    # ConformerEncoderLayer's norm_mha and norm_ff
LN_EPS = 1e-5          # the embeddings' and after_norm's LayerNorm
XVECTOR_SEED = 192     # the stand-in x-vector table's

_TABLES: dict = {}  # (L, width, device) → the relative positions' table


def rel_positions(n: int, width: int, device) -> torch.Tensor:
    """ESPnet's ``EspnetRelPositionalEncoding`` rows for positions n − 1 …
    −(n − 1): (2n − 1, width) fp32, even columns sin(r·f), odd cos(r·f),
    f_k = exp(−2k·ln 10⁴ / width); made once per shape."""
    key = (n, width, str(device))
    if key not in _TABLES:
        r = torch.arange(n - 1, -n, -1, dtype=torch.float32, device=device)
        f = torch.exp(torch.arange(0, width, 2, dtype=torch.float32, device=device) * -(math.log(10000.0) / width))
        ang = r[:, None] * f[None]
        _TABLES[key] = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(2 * n - 1, width)
    return _TABLES[key]


def xvector_table(cfg: CosyFlowConfig) -> torch.Tensor:
    """The stand-in x-vectors: ``n_xvectors`` unit rows of ``spk_embed_dim``
    from a fixed seed, the same in every run (CPU)."""
    e = torch.randn((cfg.n_xvectors, cfg.spk_embed_dim), generator=torch.Generator().manual_seed(XVECTOR_SEED),
                    device="cpu")
    return F.normalize(e, dim=1)


class LinearEmbed(nn.Module):
    """``LinearNoSubsampling`` with ``EspnetRelPositionalEncoding``: the
    input's Linear → LN → Dropout, ·√d → Dropout, and the dropped positions."""

    def __init__(self, d: int, p: float, dtype):
        super().__init__()
        self.p = p
        # indices as the published Sequential(Linear, LayerNorm, Dropout)
        self.out = nn.ModuleList([Linear(d, d, dtype=dtype), LayerNorm(d, eps=LN_EPS), nn.Identity()])

    def forward(self, x, gen):
        d = self.out[0].out_features
        h = dropout(self.out[1](self.out[0](x)), self.p, gen) * math.sqrt(d)
        h = dropout(h, self.p, gen)
        return h, dropout(rel_positions(x.shape[1], d, x.device), self.p, gen)


class PreLookahead(nn.Module):
    def __init__(self, d: int, lookahead: int, dtype):
        super().__init__()
        self.lookahead = lookahead
        self.conv1 = Conv1d(d, d, lookahead + 1, padding=0, dtype=dtype)
        self.conv2 = Conv1d(d, d, 3, padding=0, dtype=dtype)

    def forward(self, h):
        y = F.leaky_relu(self.conv1(F.pad(h, (0, 0, 0, self.lookahead))).float(), LEAKY_SLOPE)
        return h + self.conv2(F.pad(y, (0, 0, 2, 0))).float()


class RelPositionAttention(nn.Module):
    """ESPnet's ``RelPositionMultiHeadedAttention`` (key bias on)."""

    def __init__(self, d: int, heads: int, p: float, dtype):
        super().__init__()
        self.h, self.d_k, self.p = heads, d // heads, p
        self.linear_q = Linear(d, d, dtype=dtype)
        self.linear_k = Linear(d, d, dtype=dtype)
        self.linear_v = Linear(d, d, dtype=dtype)
        self.linear_out = Linear(d, d, dtype=dtype)
        self.linear_pos = Linear(d, d, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads))

    def forward(self, a, valid, pos, chunk, gen):
        b, t, _ = a.shape

        def heads(y):
            return y.reshape(y.shape[0], -1, self.h, self.d_k).transpose(1, 2)

        o = relpos_attention(heads(self.linear_q(a)), heads(self.linear_k(a)), heads(self.linear_v(a)),
                             heads(self.linear_pos(pos[None])), self.pos_bias_u, self.pos_bias_v, valid, chunk,
                             None if gen is None else lambda w: dropout(w, self.p, gen))
        return self.linear_out(o.transpose(1, 2).reshape(b, t, -1))


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d: int, hidden: int, p: float, dtype):
        super().__init__()
        self.p = p
        self.w_1 = Linear(d, hidden, dtype=dtype)
        self.w_2 = Linear(hidden, d, dtype=dtype)

    def forward(self, x, gen):
        return self.w_2(dropout(F.silu(self.w_1(x)), self.p, gen))


class ConformerLayer(nn.Module):
    """``ConformerEncoderLayer`` pre-norm, without the macaron FFN or the
    conv module: attention then FFN, each a dropped residual branch."""

    def __init__(self, cfg: CosyFlowConfig, dtype):
        super().__init__()
        d, p = cfg.encoder_dim, cfg.encoder_dropout
        self.p = p
        self.self_attn = RelPositionAttention(d, cfg.encoder_heads, p, dtype)
        self.feed_forward = PositionwiseFeedForward(d, cfg.encoder_ffn, p, dtype)
        self.norm_ff = LayerNorm(d, eps=ATTN_LN_EPS, dtype=dtype)
        self.norm_mha = LayerNorm(d, eps=ATTN_LN_EPS, dtype=dtype)

    def forward(self, h, valid, pos, chunk, gen):
        h = h + dropout(self.self_attn(self.norm_mha(h), valid, pos, chunk, gen).float(), self.p, gen)
        return h + dropout(self.feed_forward(self.norm_ff(h), gen).float(), self.p, gen)


class Upsample(nn.Module):
    """Nearest ×``stride`` in time, 2·stride frames of zeros on the left, then
    a conv of 2·stride + 1 taps: frame f sees tokens up to ⌊f / stride⌋."""

    def __init__(self, d: int, stride: int, dtype):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(d, d, 2 * stride + 1, padding=0, dtype=dtype)

    def forward(self, h):
        h = F.pad(h.repeat_interleave(self.stride, dim=1), (0, 0, 2 * self.stride, 0))
        return self.conv(h).float()


class UpsampleConformerEncoder(nn.Module):
    def __init__(self, cfg: CosyFlowConfig, dtype):
        super().__init__()
        d = cfg.encoder_dim
        self.embed = LinearEmbed(d, cfg.encoder_dropout, dtype)
        self.pre_lookahead_layer = PreLookahead(d, cfg.pre_lookahead, dtype)
        self.encoders = nn.ModuleList(ConformerLayer(cfg, dtype) for _ in range(cfg.encoder_layers))
        self.up_layer = Upsample(d, cfg.token_mel_ratio, dtype)
        self.up_embed = LinearEmbed(d, cfg.encoder_dropout, dtype)
        self.up_encoders = nn.ModuleList(ConformerLayer(cfg, dtype) for _ in range(cfg.up_layers))
        self.after_norm = LayerNorm(d, eps=LN_EPS)

    def forward(self, h, tok_valid, frame_valid, chunks: tuple[int, int], gen):
        """(B, L, d) embedded tokens → (B, T, d) fp32 at T = ratio·L frames."""
        h, pos = self.embed(h, gen)
        h = self.pre_lookahead_layer(h)
        for layer in self.encoders:
            h = layer(h, tok_valid, pos, chunks[0], gen)
        h, pos = self.up_embed(self.up_layer(h), gen)
        for layer in self.up_encoders:
            h = layer(h, frame_valid, pos, chunks[1], gen)
        return self.after_norm(h)


def row_draws(seed: int, step: int, b: int, cfg_rate: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(prompt on (B,) bool, prompt-length uniforms (B,), guidance kept (B,)
    bool) of step ``step``, on the host."""
    u = torch.rand((3, b), generator=torch.Generator().manual_seed(step_seed(seed, step, *ROW_WORDS)))
    return u[0] >= 1.0 - PROMPT_PROB, u[1], u[2] > cfg_rate


class CosyFlow(nn.Module):
    """``CausalMaskedDiffWithXvec``: the token embedding, the speaker's
    affine layer, the encoder and its projection, and the CFM's estimator
    under ``decoder.estimator``."""

    # what ``train/step.py`` asks of the model class (as of ``matcha.MatchaTTS``)
    METRICS = (("loss", "loss"),)
    PARALLEL = False      # data and tensor parallelism are not ported for it
    DROPOUT_WORDS = (2,)  # after (seed, step, rank): the dropout masks apart from the step's draws

    def __init__(self, cfg: CosyFlowConfig):
        super().__init__()
        dtype = compute_dtype(cfg.compute_dtype)
        self.cfg, self.dtype = cfg, dtype
        self.input_embedding = nn.Embedding(cfg.vocab_size, cfg.encoder_dim)
        self.spk_embed_affine_layer = Linear(cfg.spk_embed_dim, cfg.n_feats, dtype=dtype)
        self.encoder = UpsampleConformerEncoder(cfg, dtype)
        self.encoder_proj = Linear(cfg.encoder_dim, cfg.n_feats, dtype=dtype)
        est = DecoderConfig(channels=tuple(cfg.estimator_channels), dropout=cfg.estimator_dropout,
                            attention_head_dim=cfg.estimator_head_dim, n_blocks=cfg.estimator_blocks,
                            num_mid_blocks=cfg.estimator_mid, num_heads=cfg.estimator_heads, act_fn="gelu")
        self.decoder = nn.Module()
        self.decoder.estimator = Decoder(est, 4 * cfg.n_feats, cfg.n_feats, dtype=dtype, causal=True)
        self.register_buffer("xvectors", xvector_table(cfg), persistent=False)
        # training steps streaming, rows prompted, rows with the conditions dropped
        self.drawn = {"streaming": 0, "prompted": 0, "dropped": 0}

    @staticmethod
    def init_params(cfg: CosyFlowConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """A random state_dict (CPU, fp32) by ``layers.random_state_dict``'s
        rule: matrices, kernels, the embedding and the position biases
        normal, std 1/sqrt(fan-in); norm scales one; biases zero."""
        with torch.device("meta"):
            model = CosyFlow(cfg)
        return random_state_dict(model, generator)

    @staticmethod
    def param_table(cfg: CosyFlowConfig) -> list[tuple[str, str, str]]:
        """(torch name, tree path, "torch") for every parameter: the
        checkpoint tree nests the torch names by their dots, and every leaf
        decays (the recipe's decay is 0)."""
        with torch.device("meta"):
            names = list(CosyFlow(cfg).state_dict())
        return [(name, name.replace(".", "/"), "torch") for name in names]

    @staticmethod
    def batch_inputs(batch) -> tuple:
        """The fields of a ``train.step.Batch`` that ``compute_losses`` takes, in order."""
        return batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.spks

    def step_kwargs(self, seed: int, step: int, count: bool) -> dict:
        """Step ``step``'s streaming draw and the seed of its rows' draws, as
        ``compute_losses`` keywords; ``count``: a training step's, counted
        in ``drawn``."""
        u = torch.rand((1,), generator=torch.Generator().manual_seed(step_seed(seed, step, *STREAM_WORDS)))
        streaming = bool(u[0] < STREAMING_PROB)
        if count:
            self.drawn["streaming"] += streaming
        return {"streaming": streaming, "draw_seed": (seed, step), "count": count}

    def forward(self, *args, **kwargs):
        return self.compute_losses(*args, **kwargs)

    def chunks(self, streaming: bool) -> tuple[int, int]:
        """The attention chunks (tokens, frames) of a step: 0 where not streaming."""
        return (self.cfg.chunk, self.cfg.estimator_chunk) if streaming else (0, 0)

    def encode(self, tokens, tok_valid, chunks: tuple[int, int], gen=None):
        """μ (B, T, n_feats) fp32 from (B, L) token ids and their (B, L) mask."""
        ratio = self.cfg.token_mel_ratio
        h = self.input_embedding(tokens.long()) * tok_valid[..., None]
        h = self.encoder(h, tok_valid, tok_valid.repeat_interleave(ratio, dim=1), chunks, gen)
        return self.encoder_proj(h).float()

    def speaker(self, spks):
        """e′ (B, n_feats) fp32: the rows' x-vectors, normalised, through the affine layer."""
        return self.spk_embed_affine_layer(F.normalize(self.xvectors[spks.long()], dim=1)).float()

    def compute_losses(self, x, x_lengths, y, y_lengths, spks, generator: torch.Generator, *,
                       streaming: bool = False, draw_seed: tuple[int, int] = (0, 0), count: bool = False,
                       row_weights=None, dropout_generator: torch.Generator | None = None,
                       deterministic: bool = False):
        """The flow-matching loss of one padded batch: x (B, Tx) token ids,
        y (B, T, n_feats) mel, lengths (B,), spks (B,) x-vector rows.
        ``generator`` draws t and z; ``dropout_generator`` the dropout masks
        (``generator`` if None; ``deterministic`` turns dropout off);
        ``streaming`` and ``draw_seed`` = (seed, step) of the rows' draws
        come from ``step_kwargs``.  ``row_weights`` (B,) weight each row (0
        for fill rows)."""
        cfg = self.cfg
        b, n, c = y.shape
        dev = y.device
        w = torch.ones((b,), dtype=torch.float32, device=dev) if row_weights is None else row_weights.float()
        drop = None if deterministic else dropout_generator if dropout_generator is not None else generator
        chunks = self.chunks(streaming)
        n_tok = n // cfg.token_mel_ratio
        tokens = x[:, :n_tok] if x.shape[1] >= n_tok else F.pad(x, (0, n_tok - x.shape[1]))
        with annotate("matcha/train.encoder"):
            mu = self.encode(tokens, sequence_mask(x_lengths, n_tok), chunks, drop)
        with annotate("matcha/train.cfm"):
            prompt_on, prompt_u, kept = row_draws(*draw_seed, b, cfg.cfg_rate)
            if count:
                self.drawn["prompted"] += int(prompt_on.sum())
                self.drawn["dropped"] += int((~kept).sum())
            prompt_on, prompt_u, kept = (v.to(dev, non_blocking=True) for v in (prompt_on, prompt_u, kept))
            t = torch.rand((b,), generator=generator, device=dev)
            t = 1.0 - torch.cos(t * (0.5 * math.pi))
            z = torch.randn((b, n, c), generator=generator, device=dev)
            x1 = y.float()
            t3 = t[:, None, None]
            yt = (1.0 - (1.0 - cfg.sigma_min) * t3) * z + t3 * x1
            target = x1 - (1.0 - cfg.sigma_min) * z
            lengths = y_lengths.long()
            n_prompt = (prompt_u * ((PROMPT_TENTHS * lengths) // 10 + 1)).long() * prompt_on
            cond = x1 * (torch.arange(n, device=dev)[None] < n_prompt[:, None])[..., None]
            keep = kept.float()
            spk = self.speaker(spks) * keep[:, None]
            conds = torch.cat([mu * keep[:, None, None], spk[:, None].expand(b, n, c),
                               cond * keep[:, None, None]], dim=-1)
            mask = sequence_mask(lengths, n).float()
            with annotate("matcha/train.estimator"):
                pred = self.decoder.estimator(yt, mask, conds, t, chunk=chunks[1])
            weight = mask * w[:, None]
            loss = ((pred - target).square().sum(-1) * weight).sum() / (weight.sum() * c)
        return {"loss": loss}
