"""Relative-position self-attention (Transformer-XL's, as ESPnet's
``RelPositionMultiHeadedAttention`` computes it), in plain PyTorch ops.

CosyVoice 2's flow encoder (``models/cosyflow.py``) attends with it:

  score(i, j) = [(q_i + u)·k_j + (q_i + w)·p_(i−j)] / √D

over the keys query i sees (valid, and with ``chunk`` c > 0 below
(⌊i/c⌋ + 1)·c: ``ops/attention.attention_keep``), then softmax, dropout of
the probabilities, and the product with v.  p holds the projected
positions L − 1 … −(L − 1), one row each; the second term is the
source's ``rel_shift`` of (q + w)·pᵀ, a (T, 2T − 1) product shifted so
that row i, column j reads position i − j.

Precision: the three products take their operands in q's dtype with fp32
accumulation; the scores, the mask and the softmax statistics are fp32,
and the probabilities are rounded to q's dtype once.  Only that rounded
tensor is kept for the backward (``_Softmax``): no fp32 (T, T) tensor
outlives the forward.  The same code runs on every device; a
hand-written kernel is a later step.

``relpos_attention_count`` counts the calls with their signature (B, H, T,
D, chunk), as the kernels' ``LaunchCounter``s do.
"""

from __future__ import annotations

import math

import torch

from matcha_tpu_torch.ops.attention import attention_keep
from matcha_tpu_torch.ops.extension import LaunchCounter

relpos_attention_count = LaunchCounter("relpos_attention")


class _Softmax(torch.autograd.Function):
    """Softmax over the last axis of fp32 scores, returned in ``dtype``; the
    backward forms dS = P∘(dP − rowsum(dP∘P)) in fp32 from that rounded P."""

    @staticmethod
    def forward(ctx, scores, dtype):
        p = torch.softmax(scores, dim=-1).to(dtype)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, grad):
        (p,) = ctx.saved_tensors
        pf, gf = p.float(), grad.float()
        return pf * (gf - (gf * pf).sum(-1, keepdim=True)), None


def rel_shift(bd):
    """(B, H, T, 2T − 1) products with the positions T − 1 … −(T − 1) →
    (B, H, T, T) with out[i, j] = bd[i, T − 1 − i + j], position i − j: the
    source's shift (a zero column in front, the rows re-cut, the first
    dropped)."""
    b, h, t, n = bd.shape
    padded = torch.cat([bd.new_zeros(b, h, t, 1), bd], dim=-1).reshape(b, h, n + 1, t)
    return padded[:, :, 1:].reshape(b, h, t, n)[..., :t]


def relpos_attention(q, k, v, p, pos_bias_u, pos_bias_v, key_valid, chunk: int = 0, weights_dropout=None):
    """q, k, v (B, H, T, D); p (1 or B, H, 2T − 1, D); ``pos_bias_u``,
    ``pos_bias_v`` (H, D) fp32; ``key_valid`` (B, T).  ``weights_dropout``,
    a function of the probabilities, is the training-mode dropout.  Returns
    (B, H, T, D) in v's dtype."""
    b, h, t, d = q.shape
    relpos_attention_count.add((b, h, t, d, chunk))
    dt = q.dtype
    qu = (q.float() + pos_bias_u[:, None]).to(dt)
    qw = (q.float() + pos_bias_v[:, None]).to(dt)
    ac = torch.matmul(qu, k.transpose(-1, -2))
    bd = rel_shift(torch.matmul(qw, p.to(dt).transpose(-1, -2)))
    scores = (ac.float() + bd.float()) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~attention_keep(key_valid, t, chunk), float("-inf"))
    probs = _Softmax.apply(scores, dt)
    if weights_dropout is not None:
        probs = weights_dropout(probs)
    return torch.matmul(probs, v)
