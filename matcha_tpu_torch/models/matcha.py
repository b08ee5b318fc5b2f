"""MatchaTTS-24k, synthesis half: encoder, CFM decoder, speaker tables.

PyTorch counterpart of ``matcha_tpu/models/matcha.py`` (``encode``,
``decode``, ``speaker_embeddings``).  ``compute_losses`` and MAS wait for the
training path.  ``init_params`` draws a random state_dict at any config
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.models.decoder import Decoder
from matcha_tpu_torch.models.flow_matching import cfm_synthesise
from matcha_tpu_torch.models.text_encoder import TextEncoder
from matcha_tpu_torch.text.symbols import N_VOCAB

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"compute dtype {name!r} not in {tuple(DTYPES)}")
    return DTYPES[name]


class CFM(nn.Module):
    """Holds the U-Net as ``estimator``, keeping the reference weight names
    (``decoder.estimator.*``)."""

    def __init__(self, estimator: Decoder):
        super().__init__()
        self.estimator = estimator


class MatchaTTS(nn.Module):
    def __init__(self, cfg: MatchaConfig):
        super().__init__()
        self.cfg = cfg
        dtype = compute_dtype(cfg.compute_dtype)
        self.speaker_embeddings_enc = nn.Embedding(cfg.n_spks, cfg.spk_emb_dim)
        self.speaker_embeddings_dur = nn.Embedding(cfg.n_spks, cfg.spk_emb_dim)
        self.encoder = TextEncoder(
            cfg.encoder, cfg.duration_predictor, N_VOCAB, cfg.spk_emb_dim,
            dtype=dtype, attn_backend=cfg.attention_backend,
        )
        self.decoder = CFM(Decoder(
            cfg.decoder, 2 * cfg.n_feats, cfg.n_feats, dtype=dtype,
            attn_backend=cfg.attention_backend,
        ))

    def encode(self, x, x_mask, spk_enc, spk_dur):
        """Text → (mu_x, raw durations in fine frames).

        exp(logw) - 2 undoes the training-time +2 shift (reference:
        matcha/inference.py:126-128).
        """
        mu_x, logw = self.encoder(x, x_mask, spk_enc, spk_dur)
        return mu_x, (torch.exp(logw) - 2.0) * x_mask

    def decode(self, mu_y, y_mask, n_timesteps: int, solver: str | None = None, *,
               noise: torch.Tensor, masked_norm: bool = True):
        """Prior → mel via the CFM ODE; GroupNorm statistics over valid
        frames by default (see the JAX package's ``decode``)."""
        estimator = self.decoder.estimator

        def velocity(xt, mask, mu, t):
            return estimator(xt, mask, mu, t, masked_norm=masked_norm)

        return cfm_synthesise(
            velocity, mu_y, y_mask, n_timesteps, noise=noise,
            solver=solver or self.cfg.cfm.solver, use_mu_prior=self.cfg.cfm.use_mu_prior,
        )

    def speaker_embeddings(self, spks):
        return self.speaker_embeddings_enc(spks), self.speaker_embeddings_dur(spks)


def random_state_dict(module: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights for ``module`` from ``generator``, by parameter name.

    Matrices and conv kernels: normal with std 1/sqrt(fan-in); norm scales
    one; biases, norm shifts and SnakeBeta's log-scale alpha/beta zero; the
    FiLM projection starts as identity (zero weight, bias [1, 0]) and Vocos'
    layer scale at 1e-6, as the JAX package initialises them.
    """
    out = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "encoder.emb.weight":
            val = torch.randn(shape, generator=generator) * shape[1] ** -0.5
        elif name.startswith("speaker_embeddings"):
            val = torch.randn(shape, generator=generator) * shape[1] ** -0.5
        elif name == "encoder.proj_w.spk_proj.weight":
            val = torch.zeros(shape)
        elif name == "encoder.proj_w.spk_proj.bias":
            val = torch.cat([torch.ones(shape[0] // 2), torch.zeros(shape[0] - shape[0] // 2)])
        elif leaf == "gamma" and name.startswith("backbone.convnext"):
            val = torch.full(shape, 1e-6)
        elif leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
            val = torch.ones(shape)
        elif leaf in ("bias", "beta", "alpha"):
            val = torch.zeros(shape)
        else:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            val = torch.randn(shape, generator=generator) * fan_in ** -0.5
        out[name] = val.to(torch.float32)
    return out


def init_params(cfg: MatchaConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random MatchaTTS state_dict (CPU, fp32) at any config."""
    return random_state_dict(MatchaTTS(cfg), generator)
