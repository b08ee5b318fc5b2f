"""Analytic FLOP count of synthesis and of one training step.

The port's counterpart of ``bench.py::_cost_flops``, which reads XLA's cost
analysis of the compiled programs.  Here the work is counted from the
config and the shapes alone, not from anything that runs: the count is the
same whether the hand-written attention kernel or the plain einsum computes
a product, so a kernel change cannot move it, and a kernel that skips
masked key tiles cannot make the work look smaller.

Convention (``torch.utils.flop_counter.FlopCounterMode``'s): 2 FLOP per
multiply-add of every matmul, convolution and attention product (q·kᵀ and
p·v); no FFT (the ISTFT head), norm, softmax or elementwise work, no bias.
A convolution counts every output frame, padding included.  A training
step counts the forward and, for each product, the backward products
autograd forms: the weight's gradient, and the input's where the input
needs one (two products for each attention product); products that run
without grad (the MAS log-prior) count once.

  synthesis_flops(cfg, vocos_cfg, batch, tx, y_fine_len, n_timesteps, solver)
      text encoder at ``tx`` (with the duration predictor), one U-Net
      evaluation per solver stage at ``y_fine_len // 2`` coarse frames,
      Vocos on those frames
  train_step_flops(cfg, batch, tx, frames)
      ``compute_losses`` at ``frames`` coarse frames, forward and backward
  dit_train_step_flops(cfg, batch, frames)
      F5-TTS's DiT (``models/dit.py``) on ``frames`` mel frames, forward
      and backward: the time MLP's first layer takes no input gradient,
      the input projection its whole input's (the text part needs one);
      no embedding lookup, GRN or RoPE

``*_products`` list the products of one module, for a breakdown by
component (``utils/profile_stage_b.py``).  Only the transformer decoder is
counted; ``block_type="conformer"`` raises.
"""

from __future__ import annotations

from typing import NamedTuple

from matcha_tpu_torch.models.config import DiTConfig, MatchaConfig
from matcha_tpu_torch.models.dit import CONV_MULT, CONV_POS_GROUPS, CONV_POS_KERNEL, FREQ_EMBED_DIM

# U-Net evaluations per solver step (models/flow_matching.py)
EVALS_PER_STEP = {"euler": 1, "midpoint": 2, "heun3": 3, "rk4": 4}


class Product(NamedTuple):
    """One product: its forward FLOP and how many products of the same size
    its backward forms (0: run without grad)."""

    name: str
    flops: float
    backward: int


def _conv(name, b, t_out, cin, cout, k=1, groups=1, grad_input=True) -> Product:
    """A convolution (a kernel-1 conv or a dense layer is a matmul of the
    same count) over ``t_out`` output frames; the weight's gradient, and
    the input's where ``grad_input``."""
    return Product(name, 2.0 * b * t_out * (cin // groups) * cout * k, 1 + grad_input)


def _attention(name, b, heads, t, head_dim) -> list[Product]:
    """q·kᵀ and p·v over all T keys; both operands of each need gradients."""
    f = 2.0 * b * heads * t * t * head_dim
    return [Product(f"{name}.qk", f, 2), Product(f"{name}.pv", f, 2)]


def text_encoder_products(cfg: MatchaConfig, b: int, tx: int) -> list[Product]:
    """Prenet, transformer layers, mel head and duration predictor at ``tx``
    tokens (models/text_encoder.py)."""
    enc, dp = cfg.encoder, cfg.duration_predictor
    c, s = enc.n_channels, cfg.spk_emb_dim
    ce = c + s
    out = []
    if enc.prenet:
        out += [_conv(f"prenet.conv{i}", b, tx, c, c, enc.prenet_kernel_size) for i in range(enc.prenet_layers)]
        out.append(_conv("prenet.proj", b, tx, c, c))
    for i in range(enc.n_layers):
        out += [_conv(f"layer{i}.conv_{n}", b, tx, ce, ce) for n in "qkvo"]
        out += _attention(f"layer{i}.attention", b, enc.n_heads, tx, ce // enc.n_heads)
        out += [_conv(f"layer{i}.ffn1", b, tx, ce, enc.filter_channels, enc.kernel_size),
                _conv(f"layer{i}.ffn2", b, tx, enc.filter_channels, ce, enc.kernel_size)]
    out += [_conv("proj_m.0", b, tx, ce, c), _conv("proj_m.2", b, tx, c, cfg.n_feats)]
    fd = dp.filter_channels
    out.append(_conv("proj_w.spk_proj", b, 1, s, 2 * fd))
    for i in range(dp.n_layers):
        # the duration predictor reads a detached copy of the encoder output
        out.append(_conv(f"proj_w.conv{i}", b, tx, ce if i == 0 else fd, fd, dp.kernel_size, grad_input=i > 0))
    out.append(_conv("proj_w.proj", b, tx, fd, 1))
    return out


def transformer_block_products(cfg: MatchaConfig, b: int, t: int, dim: int) -> list[Product]:
    """One decoder transformer block of width ``dim`` at ``t`` frames:
    q, k, v, attention, output projection, SnakeBeta FFN (×4)."""
    dec = cfg.decoder
    inner = dec.num_heads * dec.attention_head_dim
    return ([_conv(f"to_{n}", b, t, dim, inner) for n in "qkv"]
            + _attention("attention", b, dec.num_heads, t, dec.attention_head_dim)
            + [_conv("to_out", b, t, inner, dim), _conv("ff.proj", b, t, dim, 4 * dim),
               _conv("ff.out", b, t, 4 * dim, dim)])


def resnet_block_products(cfg: MatchaConfig, b: int, t: int, dim_in: int, dim_out: int,
                          grad_input: bool = True) -> list[Product]:
    """One ResnetBlock1D: time-embedding projection, two conv3 blocks, the
    kernel-1 residual (``grad_input``: the block's input needs a gradient)."""
    ted = 4 * cfg.decoder.channels[0]
    return [_conv("mlp", b, 1, ted, dim_out), _conv("block1", b, t, dim_in, dim_out, 3, grad_input=grad_input),
            _conv("block2", b, t, dim_out, dim_out, 3), _conv("res_conv", b, t, dim_in, dim_out, grad_input=grad_input)]


def decoder_products(cfg: MatchaConfig, b: int, t: int) -> list[Product]:
    """One U-Net evaluation at ``t`` coarse frames (models/decoder.py); its
    input (the noisy sample and the detached prior) needs no gradient."""
    dec = cfg.decoder
    if dec.block_type != "transformer":
        raise ValueError(f"decoder block_type {dec.block_type!r}: only the transformer decoder is counted")
    ch = tuple(dec.channels)
    in_ch, ted = 2 * cfg.n_feats, 4 * ch[0]
    lengths = [t >> i for i in range(len(ch))]

    def stage(resnet, dim, length):
        return resnet + [p for _ in range(dec.n_blocks) for p in transformer_block_products(cfg, b, length, dim)]

    out = [_conv("time_mlp.1", b, 1, in_ch, ted, grad_input=False), _conv("time_mlp.2", b, 1, ted, ted)]
    for i, c in enumerate(ch):
        last = i == len(ch) - 1
        dim_in = in_ch if i == 0 else ch[i - 1]
        out += stage(resnet_block_products(cfg, b, lengths[i], dim_in, c, grad_input=i > 0), c, lengths[i])
        out.append(_conv("down", b, lengths[i] if last else lengths[i] // 2, c, c, 3))
    for _ in range(dec.num_mid_blocks):
        out += stage(resnet_block_products(cfg, b, lengths[-1], ch[-1], ch[-1]), ch[-1], lengths[-1])
    up_ch = ch[::-1] + (ch[0],)
    for i in range(len(up_ch) - 1):
        last = i == len(up_ch) - 2
        length, out_c = lengths[len(ch) - 1 - i], up_ch[i + 1]
        out += stage(resnet_block_products(cfg, b, length, 2 * up_ch[i], out_c), out_c, length)
        # the transposed conv counts its input frames (FlopCounterMode's rule)
        out.append(_conv("up", b, length, out_c, out_c, 3 if last else 4))
    out += [_conv("final_block", b, t, ch[0], ch[0], 3), _conv("final_proj", b, t, ch[0], cfg.n_feats)]
    return out


def vocos_products(vocos_cfg, b: int, t: int) -> list[Product]:
    """Vocos on ``t`` mel frames: the embedding conv, the ConvNeXt blocks
    (depthwise conv7, two pointwise layers), the ISTFT head's projection
    (its inverse FFT is not counted)."""
    v = vocos_cfg
    out = [_conv("embed", b, t, v.input_channels, v.dim, 7)]
    for i in range(v.num_layers):
        out += [_conv(f"convnext{i}.dwconv", b, t, v.dim, v.dim, 7, groups=v.dim),
                _conv(f"convnext{i}.pwconv1", b, t, v.dim, v.intermediate_dim),
                _conv(f"convnext{i}.pwconv2", b, t, v.intermediate_dim, v.dim)]
    out.append(_conv("head.out", b, t, v.dim, v.n_fft + 2))
    return out


def forward_flops(products) -> float:
    return float(sum(p.flops for p in products))


def step_flops(products) -> float:
    """Forward and backward FLOP of ``products`` in a training step."""
    return float(sum(p.flops * (1 + p.backward) for p in products))


def coarse_frames(y_fine_len: int) -> int:
    """The decoder's frames at a fine mel bucket (``downsample_time``)."""
    return -(-y_fine_len // 2)


def unet_evaluations(n_timesteps: int, solver: str) -> int:
    if solver not in EVALS_PER_STEP:
        raise ValueError(f"unknown solver {solver!r}; choose from {tuple(EVALS_PER_STEP)}")
    return EVALS_PER_STEP[solver] * n_timesteps


def synthesis_flops(cfg: MatchaConfig, vocos_cfg, batch: int, tx: int, y_fine_len: int,
                    n_timesteps: int = 4, solver: str = "midpoint") -> float:
    """FLOP of one synthesis call of ``batch`` rows at text bucket ``tx`` and
    fine mel bucket ``y_fine_len`` (two-stage or fused: the same work);
    ``vocos_cfg=None`` counts no vocoder."""
    t = coarse_frames(y_fine_len)
    total = forward_flops(text_encoder_products(cfg, batch, tx))
    total += unet_evaluations(n_timesteps, solver) * forward_flops(decoder_products(cfg, batch, t))
    if vocos_cfg is not None:
        total += forward_flops(vocos_products(vocos_cfg, batch, t))
    return total


def train_step_flops(cfg: MatchaConfig, batch: int, tx: int, frames: int) -> float:
    """FLOP of one training step on a (``batch``, ``tx`` tokens, ``frames``
    coarse frames) bucket: ``compute_losses`` forward and backward.  The
    MAS log-prior (a (tx × 2·frames × n_feats) product a row) runs without
    grad; MAS itself and the optimizer are not products."""
    log_prior = Product("log_prior", 2.0 * batch * tx * 2 * frames * cfg.n_feats, 0)
    return step_flops(text_encoder_products(cfg, batch, tx) + [log_prior]
                      + decoder_products(cfg, batch, frames))


def dit_products(cfg: DiTConfig, b: int, n: int) -> list[Product]:
    """The DiT's products on ``b`` rows of ``n`` frames (``models/dit.py``)."""
    d, td = cfg.dim, cfg.text_dim
    inner, hidden = cfg.heads * cfg.dim_head, cfg.dim * cfg.ff_mult
    out = [_conv("time_mlp.0", b, 1, FREQ_EMBED_DIM, d, grad_input=False), _conv("time_mlp.2", b, 1, d, d)]
    for i in range(cfg.conv_layers):
        out += [_conv(f"text{i}.dwconv", b, n, td, td, 7, groups=td),
                _conv(f"text{i}.pwconv1", b, n, td, td * CONV_MULT),
                _conv(f"text{i}.pwconv2", b, n, td * CONV_MULT, td)]
    out.append(_conv("input.proj", b, n, 2 * cfg.n_feats + td, d))
    out += [_conv(f"input.conv_pos{i}", b, n, d, d, CONV_POS_KERNEL, groups=CONV_POS_GROUPS)
            for i in range(2)]
    for i in range(cfg.depth):
        out.append(_conv(f"block{i}.adaln", b, 1, d, 6 * d))
        out += [_conv(f"block{i}.to_{x}", b, n, d, inner) for x in "qkv"]
        out += _attention(f"block{i}.attention", b, cfg.heads, n, cfg.dim_head)
        out += [_conv(f"block{i}.to_out", b, n, inner, d), _conv(f"block{i}.ff1", b, n, d, hidden),
                _conv(f"block{i}.ff2", b, n, hidden, d)]
    out += [_conv("norm_out", b, 1, d, 2 * d), _conv("proj_out", b, n, d, cfg.n_feats)]
    return out


def dit_train_step_flops(cfg: DiTConfig, batch: int, frames: int) -> float:
    return step_flops(dit_products(cfg, batch, frames))
