"""StyleEncoder: predict speaker embeddings from a mel sample.

PyTorch counterpart of ``matcha_tpu/models/style_encoder.py``: 4 convs
(kernel 5, "SAME") + ReLU on the masked input, a masked mean pool, and two
linear heads giving the (enc, dur) embedding pair, so a few recordings of a
new voice give rows for the speaker tables (``add_speaker.py``).

Training (``style_encoder_loss``) runs the frozen MatchaTTS encoder twice,
once with the true table rows and once with the StyleEncoder's
predictions, and penalizes the differences of its outputs (mu_x, logw) with
smooth-L1.  The predicted branch carries gradients into the StyleEncoder
through the frozen encoder, so on the card its attention runs the kernel
with the log-sum-exp and then the backward kernels (``MaskedAttention``);
the real branch runs without gradients and the forward kernel writes no
log-sum-exp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.models.layers import Conv1d, Linear
from matcha_tpu_torch.models.matcha import MatchaTTS, random_state_dict
from matcha_tpu_torch.utils.model_math import sequence_mask


class StyleEncoder(nn.Module):
    """(B, T, n_feats) fine mel + (B, T) mask → two (B, spk_emb_dim) embeddings,
    computed in ``dtype`` (fp32; float64 for a reference run)."""

    def __init__(self, n_feats: int, spk_emb_dim: int = 96, hidden: int = 256,
                 n_layers: int = 4, kernel_size: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"conv{i}", Conv1d(n_feats if i == 0 else hidden, hidden, kernel_size, dtype=dtype))
        self.n_layers = n_layers
        self.dtype = dtype
        self.head_enc = Linear(hidden, spk_emb_dim, dtype=dtype)
        self.head_dur = Linear(hidden, spk_emb_dim, dtype=dtype)

    def forward(self, mel: torch.Tensor, mask: torch.Tensor):
        m = mask[..., None].to(self.dtype)
        h = mel.to(self.dtype)
        for i in range(self.n_layers):
            h = torch.relu(getattr(self, f"conv{i}")(h * m))
        pooled = (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return self.head_enc(pooled), self.head_dur(pooled)


def init_style_params(cfg: MatchaConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random StyleEncoder state_dict for ``cfg``'s mel and embedding
    widths (CPU, fp32) from ``generator``."""
    return random_state_dict(StyleEncoder(cfg.n_feats, cfg.spk_emb_dim), generator)


def style_encoder_loss(style: StyleEncoder, model: MatchaTTS, batch, *,
                       acoustic_beta: float = 0.002, rhythm_beta: float = 0.004):
    """Smooth-L1 losses against the frozen MatchaTTS encoder.

    ``batch`` is a ``train.step.Batch`` (x, x_lengths, y_fine,
    y_fine_lengths, spks are read).  ``model``'s parameters should not
    require grad; gradients reach ``style``'s.  The encoder runs
    deterministically.  Each loss is ``smooth_l1(beta, sum) /
    max(Σ x_mask, 1)``, which is the JAX package's ``huber(delta=β) / β``.
    Returns (loss, {"acoustic": ..., "rhythm": ...}).
    """
    y_fine_mask = sequence_mask(batch.y_fine_lengths, batch.y_fine.shape[1]).float()
    pred_enc, pred_dur = style(batch.y_fine, y_fine_mask)
    x_mask = sequence_mask(batch.x_lengths, batch.x.shape[1]).float()
    with torch.no_grad():
        real_enc, real_dur = model.speaker_embeddings(batch.spks)
        mu_real, w_real = model.encoder(batch.x, x_mask, real_enc, real_dur)
    mu_pred, w_pred = model.encoder(batch.x, x_mask, pred_enc, pred_dur)
    m3 = x_mask[..., None]
    denom = torch.clamp(x_mask.sum(), min=1.0)
    # mu and logw leave the encoder's fp32 islands (float64 in a float64 run)
    acoustic = F.smooth_l1_loss(mu_pred * m3, mu_real * m3, beta=acoustic_beta, reduction="sum") / denom
    rhythm = F.smooth_l1_loss(w_pred * x_mask, w_real * x_mask, beta=rhythm_beta, reduction="sum") / denom
    return acoustic + rhythm, {"acoustic": acoustic.detach(), "rhythm": rhythm.detach()}
