"""Shape/alignment math shared across the port.

PyTorch counterparts of ``matcha_tpu/utils/model_math.py`` (reference:
matcha/utils/model.py).  Same (B, T, C) time-major layout and semantics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NUM_UNET_DOWNSAMPLES = 1  # len(decoder channels) - 1; see models/config.py


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths → (B, max_length) boolean mask (True = valid)."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamples: int = NUM_UNET_DOWNSAMPLES) -> int:
    """Round a frame count up so the U-Net can halve it cleanly (host-side)."""
    factor = 2**num_downsamples
    return int(-(-length // factor) * factor)


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, Tx) durations + (B, Tx, Ty) mask → (B, Tx, Ty) hard alignment.

    Row i is 1 on frames [cum[i-1], cum[i]) (reference:
    matcha/utils/model.py:24-40).
    """
    b, _, t_y = mask.shape
    cum = torch.cumsum(duration.to(torch.int32), dim=1)
    pos = torch.arange(t_y, dtype=torch.int32, device=mask.device)
    upper = pos[None, None, :] < cum[:, :, None]
    prev = torch.cat([torch.zeros((b, 1), dtype=cum.dtype, device=cum.device), cum[:, :-1]], dim=1)
    lower = pos[None, None, :] >= prev[:, :, None]
    return (upper & lower).to(mask.dtype) * mask


def normalize(data: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Corpus-global standardization; invertible without per-utterance stats."""
    return (data - mean) / std


def denormalize(data: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    return data * std + mean


def downsample_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) → (B, ceil(T/2), C) overlapping 3-frame average.

    avg_pool1d(kernel=3, stride=2, padding=1) with count_include_pad=True:
    edge windows still divide by 3.  An odd T gets one more frame of zero
    padding on the right, as in the JAX version (model_math.py:63-79).
    """
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1 + t % 2))
    windows = xp[:, 0:-2:2] + xp[:, 1:-1:2] + xp[:, 2::2]
    return windows / 3.0
