"""Analytic FLOP count of one training step of CosyVoice 2's flow stage
(``models/cosyflow.py``).

Frozen with the ``cosy-train`` cell: a copy of ``utils/flops.py``'s
``kept_pairs`` and ``cosyflow_products``.  The count comes from the
configuration, a row's length and the step's streaming draw alone, not
from anything that runs, so a kernel change cannot move it.  The
convention is ``flops.py``'s (``FlopCounterMode``'s): 2 FLOP per
multiply-add of every matmul, convolution and attention product; no norm,
softmax, elementwise work, bias or embedding lookup.  Attention counts the
(query, key) pairs the masks keep: all n² of a row of n frames (n/2
tokens in the first six encoder layers), or under a streaming step's
chunk c, Σᵢ min(n, (⌊i/c⌋ + 1)·c); for the encoder's q·kᵀ, (q + w)·p and
p·v, and the estimator's q·kᵀ and p·v.  A training step counts the forward
and, for each product, the backward products autograd forms (the weight's
gradient, and the input's where it needs one).

  cosyflow_products(cfg, b, n, streaming)   the flow stage on ``b`` rows of ``n`` frames
  train_step_flops(cfg, b, n, streaming)    forward and backward of those products
"""

from __future__ import annotations

from benchmark.flops import Product, _conv, step_flops


def kept_pairs(n: int, chunk: int = 0) -> int:
    """The (query, key) pairs of a row of ``n`` that attention keeps: n²,
    or with a chunk c, Σ over queries i of min(n, (⌊i/c⌋ + 1)·c)."""
    if not chunk:
        return n * n
    q, r = divmod(n, chunk)  # q whole chunks, each seeing itself and those before; r queries see all n
    return chunk * chunk * q * (q + 1) // 2 + r * n


def _pair_products(name, b, heads, head_dim, pairs, terms) -> list[Product]:
    """``terms`` attention products over ``pairs`` (query, key) pairs a row;
    both operands of each need gradients."""
    f = 2.0 * b * heads * head_dim * pairs
    return [Product(f"{name}.{t}", f, 2) for t in terms]


def cosyflow_products(cfg, b: int, n: int, streaming: bool) -> list[Product]:
    """The flow stage's products on ``b`` rows of ``n`` frames and ``n //
    token_mel_ratio`` tokens, its attention chunk-causal where ``streaming``."""
    d, heads = cfg.encoder_dim, cfg.encoder_heads
    tok = n // cfg.token_mel_ratio
    chunks = (cfg.chunk, cfg.chunk * cfg.token_mel_ratio) if streaming else (0, 0)

    def layers(prefix, count, t, chunk):
        out = []
        for i in range(count):
            out += [_conv(f"{prefix}{i}.linear_{x}", b, t, d, d) for x in "qkv"]
            out.append(_conv(f"{prefix}{i}.linear_pos", b, 2 * t - 1, d, d, grad_input=False))
            out += _pair_products(f"{prefix}{i}.attention", b, heads, d // heads, kept_pairs(t, chunk),
                                  ("qk", "qp", "pv"))
            out += [_conv(f"{prefix}{i}.linear_out", b, t, d, d), _conv(f"{prefix}{i}.w_1", b, t, d, cfg.encoder_ffn),
                    _conv(f"{prefix}{i}.w_2", b, t, cfg.encoder_ffn, d)]
        return out

    out = [_conv("embed", b, tok, d, d),
           _conv("lookahead.conv1", b, tok, d, d, cfg.pre_lookahead + 1), _conv("lookahead.conv2", b, tok, d, d, 3)]
    out += layers("layer", cfg.encoder_layers, tok, chunks[0])
    out += [_conv("up_layer", b, n, d, d, 2 * cfg.token_mel_ratio + 1), _conv("up_embed", b, n, d, d)]
    out += layers("up_layer", cfg.up_layers, n, chunks[1])
    out += [_conv("encoder_proj", b, n, d, cfg.n_feats),
            _conv("spk_affine", b, 1, cfg.spk_embed_dim, cfg.n_feats, grad_input=False)]
    c, ch, eh, ehd = 4 * cfg.n_feats, cfg.estimator_channels[0], cfg.estimator_heads, cfg.estimator_head_dim
    ted, inner = 4 * ch, eh * ehd

    def stage(name, dim_in):
        out = [_conv(f"{name}.mlp", b, 1, ted, ch), _conv(f"{name}.block1", b, n, dim_in, ch, 3),
               _conv(f"{name}.block2", b, n, ch, ch, 3), _conv(f"{name}.res_conv", b, n, dim_in, ch)]
        for k in range(cfg.estimator_blocks):
            out += [_conv(f"{name}.{k}.to_{x}", b, n, ch, inner) for x in "qkv"]
            out += _pair_products(f"{name}.{k}.attention", b, eh, ehd, kept_pairs(n, chunks[1]), ("qk", "pv"))
            out += [_conv(f"{name}.{k}.to_out", b, n, inner, ch), _conv(f"{name}.{k}.ff.proj", b, n, ch, 4 * ch),
                    _conv(f"{name}.{k}.ff.out", b, n, 4 * ch, ch)]
        return out

    out += [_conv("time_mlp.1", b, 1, c, ted, grad_input=False), _conv("time_mlp.2", b, 1, ted, ted)]
    out += stage("down", c) + [_conv("down.conv", b, n, ch, ch, 3)]
    for m in range(cfg.estimator_mid):
        out += stage(f"mid{m}", ch)
    out += stage("up", 2 * ch) + [_conv("up.conv", b, n, ch, ch, 3)]
    out += [_conv("final_block", b, n, ch, ch, 3), _conv("final_proj", b, n, ch, cfg.n_feats)]
    return out


def train_step_flops(cfg, batch: int, frames: int, streaming: bool) -> float:
    return step_flops(cosyflow_products(cfg, batch, frames, streaming))
