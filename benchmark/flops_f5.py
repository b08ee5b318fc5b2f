"""Analytic FLOP count of one F5-TTS training step (``models/dit.py``).

Frozen with the ``f5-train`` cell: the count comes from the configuration
and a row's length alone, not from anything that runs, so a kernel change
cannot move it.  The convention is ``flops.py``'s (``FlopCounterMode``'s):
2 FLOP per multiply-add of every matmul, convolution and attention product
(q·kᵀ and p·v over all N keys of the row); no norm, softmax, GRN, RoPE or
elementwise work, no bias, no embedding lookup.  A training step counts
the forward and, for each product, the backward products autograd forms:
the weight's gradient, and the input's where the input needs one (two for
each attention product).  The time MLP's first layer and the input
projection's noisy mel and condition need no input gradient; the input
projection counts its whole input's gradient, since the text embedding
part of it needs one and autograd forms it as one product.

  dit_products(cfg, b, n)          the DiT on ``b`` rows of ``n`` frames
  train_step_flops(cfg, b, n)      forward and backward of those products
"""

from __future__ import annotations

from benchmark.flops import Product, _attention, _conv, step_flops

# ``models/dit.py``'s module constants, frozen
CONV_MULT, FREQ_EMBED_DIM, CONV_POS_KERNEL, CONV_POS_GROUPS = 2, 256, 31, 16


def dit_products(cfg, b: int, n: int) -> list[Product]:
    d, td = cfg.dim, cfg.text_dim
    inner, hidden = cfg.heads * cfg.dim_head, cfg.dim * cfg.ff_mult
    out = [_conv("time_mlp.0", b, 1, FREQ_EMBED_DIM, d, grad_input=False),
           _conv("time_mlp.2", b, 1, d, d)]
    for i in range(cfg.conv_layers):
        # the first block's input is the embedding's output, which needs a gradient
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


def train_step_flops(cfg, b: int, n: int) -> float:
    return step_flops(dit_products(cfg, b, n))
