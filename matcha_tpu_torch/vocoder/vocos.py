"""Vocos-24k vocoder: ConvNeXt backbone + ISTFT head.

PyTorch counterpart of ``matcha_tpu/vocoder/vocos.py`` (architecture of
``charactr/vocos-mel-24khz``: dim 512, intermediate 1536, 8 ConvNeXt layers,
ISTFT head with n_fft=1024, hop=256, center padding).  Time-major (B, T, C);
submodules carry the torch Vocos names (``backbone.convnext.{i}.dwconv``,
``head.out`` ...).  The ISTFT head always runs fp32; ``torch.fft.irfft``
stands where the JAX package computes its FFT outside any kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.audio.mel import hann_window
from matcha_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, compute_dtype, random_state_dict


@dataclass(frozen=True)
class VocosConfig:
    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    sample_rate: int = 24000
    # activation dtype of the ConvNeXt backbone; the ISTFT head is fp32
    compute_dtype: str = "float32"


class ConvNeXtBlock(nn.Module):
    """Depthwise conv7 → LN → pointwise MLP (tanh GELU) → layer scale → residual."""

    def __init__(self, dim, intermediate_dim, layer_scale_init=1e-6, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dwconv = Conv1d(dim, dim, 7, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.pwconv1 = Linear(dim, intermediate_dim, dtype=dtype)
        self.pwconv2 = Linear(intermediate_dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        h = self.pwconv1(self.norm(self.dwconv(x)))
        # flax's nn.gelu defaults to the tanh approximation
        h = self.pwconv2(F.gelu(h, approximate="tanh"))
        return x + self.gamma.to(self.dtype) * h


class VocosBackbone(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        dtype = compute_dtype(cfg.compute_dtype)
        self.dtype = dtype
        self.embed = Conv1d(cfg.input_channels, cfg.dim, 7, dtype=dtype)
        self.norm = LayerNorm(cfg.dim, eps=1e-6, dtype=dtype)
        self.convnext = nn.ModuleList(
            ConvNeXtBlock(cfg.dim, cfg.intermediate_dim, dtype=dtype) for _ in range(cfg.num_layers)
        )
        # final norm in fp32: it feeds the fp32 ISTFT head
        self.final_layer_norm = LayerNorm(cfg.dim, eps=1e-6, dtype=torch.float32)

    def forward(self, mel):
        """(B, T, n_mels) log-mel → (B, T, dim) fp32 features."""
        h = self.norm(self.embed(mel.to(self.dtype)))
        for block in self.convnext:
            h = block(h)
        return self.final_layer_norm(h.float())


def overlap_add(frames, hop: int):
    """(B, T, n_fft) frames → (B, (T-1)*hop + n_fft); n_fft a multiple of hop."""
    b, t, n_fft = frames.shape
    ratio = n_fft // hop
    if ratio * hop != n_fft:
        raise ValueError("n_fft must be a multiple of hop")
    chunks = frames.reshape(b, t, ratio, hop)
    out = frames.new_zeros((b, t + ratio - 1, hop))
    for c in range(ratio):
        out[:, c:c + t] += chunks[:, :, c]
    return out.reshape(b, (t + ratio - 1) * hop)


def istft_center(spec, window, n_fft: int, hop: int):
    """(B, T, n_fft//2+1) complex spectrum → (B, (T-1)*hop) waveform, center
    padding removed (matches torch.istft)."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    sig = overlap_add(frames, hop)
    env = overlap_add(window.square().expand(1, spec.shape[1], n_fft), hop)
    sig = sig / torch.clamp(env, min=1e-11)
    pad = n_fft // 2
    return sig[:, pad:-pad]


class ISTFTHead(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        self.out = Linear(cfg.dim, cfg.n_fft + 2, dtype=torch.float32)
        self.register_buffer("window", torch.from_numpy(hann_window(cfg.n_fft)), persistent=False)

    def forward(self, h):
        """(B, T, dim) features → (B, (T-1)*hop) waveform."""
        mag, phase = self.out(h).chunk(2, dim=-1)
        mag = torch.exp(torch.clamp(mag, max=100.0))
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft_center(spec, self.window, self.cfg.n_fft, self.cfg.hop_length)


class Vocos(nn.Module):
    """Log-mel (B, T, n_mels) → waveform (B, (T-1)*hop)."""

    def __init__(self, cfg: VocosConfig = VocosConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = VocosBackbone(cfg)
        self.head = ISTFTHead(cfg)

    def forward(self, mel):
        return self.head(self.backbone(mel))


def init_vocos_params(cfg: VocosConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random Vocos state_dict (CPU, fp32) from ``generator``."""
    return random_state_dict(Vocos(cfg), generator)
