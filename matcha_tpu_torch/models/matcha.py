"""MatchaTTS-24k: encoder, monotonic alignment search, CFM decoder.

PyTorch counterpart of ``matcha_tpu/models/matcha.py``: the training losses
(``compute_losses``: duration, prior and CFM loss) and the synthesis halves
(``encode``, ``decode``, ``speaker_embeddings``).  The encoder, MAS and the
prior work at hop 128 (fine mel), the decoder at hop 256; MAS and the prior
are fp32 islands.  ``init_params`` draws a random state_dict at any config
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.models.decoder import Decoder
from matcha_tpu_torch.models.flow_matching import cfm_loss, cfm_synthesise
from matcha_tpu_torch.models.layers import compute_dtype, random_state_dict
from matcha_tpu_torch.models.text_encoder import TextEncoder
from matcha_tpu_torch.ops.mas import durations_from_indices, maximum_path_indices
from matcha_tpu_torch.text.symbols import N_VOCAB
from matcha_tpu_torch.utils.model_math import downsample_time, sequence_mask
from matcha_tpu_torch.utils.profiling import annotate

QUANTILES = (0.5, 0.9, 0.99)

def log_prior_scores(mu_x: torch.Tensor, y_fine: torch.Tensor) -> torch.Tensor:
    """(B, Tx, C) x (B, Ty, C) fp32 → (B, Tx, Ty) Gaussian log-prior −‖y−mu‖²/2.

    Expanded into y², mu·y, mu² so the cross term is one matmul
    (reference: matcha_tts.py:184-201).  It must be true fp32: on the card
    that needs TF32 off for matmuls, which the trainer sees to (the JAX
    package asks for precision=HIGHEST, PARITY.md §2.6b).
    """
    y_sq = -0.5 * y_fine.square().sum(dim=-1)  # (B, Ty)
    mu_sq = -0.5 * mu_x.square().sum(dim=-1)  # (B, Tx)
    cross = torch.einsum("bic,bjc->bij", mu_x, y_fine)
    return y_sq[:, None, :] + cross + mu_sq[:, :, None]


def linear_quantiles(x: torch.Tensor, qs=QUANTILES) -> list[torch.Tensor]:
    """``jnp.quantile(x, qs)`` (linear interpolation) over all elements.

    One sort of the flattened tensor: ``torch.quantile`` refuses inputs
    above 2**24 elements, which the prior error nears at full frame budgets.
    """
    srt = torch.sort(x.reshape(-1).float()).values
    n = srt.numel()
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        w = pos - lo
        out.append(srt[lo] * (1.0 - w) + srt[hi] * w)
    return out


class CFM(nn.Module):
    """Holds the U-Net as ``estimator``, keeping the reference weight names
    (``decoder.estimator.*``)."""

    def __init__(self, estimator: Decoder):
        super().__init__()
        self.estimator = estimator


class MatchaTTS(nn.Module):
    # what ``train/step.py`` asks of the model class (``models/dit.F5TTS`` answers too):
    # (key of compute_losses' result, name among the step's metrics)
    METRICS = (("loss", "loss"), ("diff_loss", "sub_loss/diff"), ("dur_loss", "sub_loss/dur"),
               ("prior_loss", "sub_loss/prior"))
    PARALLEL = True      # data and tensor parallelism (``parallel/``)
    DROPOUT_WORDS = ()   # after (seed, step, rank): the dropout masks' stream

    @staticmethod
    def init_params(cfg: MatchaConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The module's ``init_params``."""
        return init_params(cfg, generator)

    @staticmethod
    def param_table(cfg: MatchaConfig) -> list[tuple[str, str, str]]:
        """(torch name, flax path, layout kind) of every parameter."""
        from matcha_tpu_torch.weights import matcha_param_table  # weights imports this module

        return matcha_param_table(cfg)

    @staticmethod
    def batch_inputs(batch) -> tuple:
        """The fields of a ``train.step.Batch`` that ``compute_losses`` takes, in order."""
        return (batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.y_fine, batch.y_fine_lengths,
                batch.spks)

    def step_kwargs(self, seed: int, step: int, count: bool) -> dict:
        """Keywords drawn on the host for step ``step``: none."""
        return {}

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

    def forward(self, *args, **kwargs):
        """The training losses, as the JAX module's ``__call__``."""
        return self.compute_losses(*args, **kwargs)

    def compute_losses(self, x, x_lengths, y, y_lengths, y_fine, y_fine_lengths, spks,
                       generator: torch.Generator | None = None, *,
                       deterministic: bool = False, cfm_t_noise=None, row_weights=None,
                       dropout_generator: torch.Generator | None = None,
                       sum_over_ranks=None, rows: tuple[int, int] | None = None):
        """Duration, prior and CFM losses of one padded batch
        (reference: matcha_tts.py:64-163; JAX ``compute_losses``).

        x (B, Tx) ids; y (B, Ty, C) coarse mel; y_fine (B, 2·Ty, C) fine mel;
        lengths (B,); spks (B,).  ``generator`` (on the batch's device) draws
        the dropout masks and CFM's t and noise; ``deterministic`` turns
        dropout off; ``cfm_t_noise`` fixes t and noise.  ``row_weights`` (B,)
        weight each row's losses (0 for repeat-filled rows).  Returns the
        losses, their sum ``loss``, ``mas_frames`` and the abs-error
        quantile diagnostics.

        ``dropout_generator`` draws the dropout masks instead of
        ``generator``.  Data parallelism (``train/step.py``): this process
        holds rows ``rows`` = (first, global count) of the batch;
        ``sum_over_ranks`` sums the three loss denominators (Σ x_len·w,
        Σ y_fine_len·w, Σ y_len·w·C) over the group before they divide, so
        each rank's losses are its share of the global batch's and their sum
        over ranks is the single process's loss; CFM's t and noise come at
        the global shape.  The quantile diagnostics stay per rank.
        """
        cfg = self.cfg
        dev = y.device
        w = (torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
             if row_weights is None else row_weights.float())
        x_mask = sequence_mask(x_lengths, x.shape[1]).float()
        y_mask = sequence_mask(y_lengths, y.shape[1]).float()
        y_fine_mask = sequence_mask(y_fine_lengths, y_fine.shape[1]).float()
        drop = None if deterministic else dropout_generator if dropout_generator is not None else generator
        # the batch-wide denominators of the three losses
        dens = torch.stack([(x_lengths * w).sum(), (y_fine_mask * w[:, None]).sum(),
                            (y_mask * w[:, None]).sum() * y.shape[-1]])
        if sum_over_ranks is not None:
            dens = sum_over_ranks(dens)

        with annotate("matcha/train.encoder"):
            spk_enc, spk_dur = self.speaker_embeddings(spks)
            mu_x, logw = self.encoder(x, x_mask, spk_enc, spk_dur, drop)

        # ---- MAS alignment (fp32, no gradients) ----
        mu_x32 = mu_x.float()
        y_fine32 = y_fine.float()
        with annotate("matcha/train.mas"):
            with torch.no_grad():
                log_prior = log_prior_scores(mu_x32.detach(), y_fine32)
                idx = maximum_path_indices(log_prior, x_lengths, y_fine_lengths, cfg.mas_backend)
                del log_prior
            mas_durations = durations_from_indices(idx, x.shape[1])

        # ---- duration loss (+2 keeps log targets above 1; inference undoes it) ----
        logw_target = torch.log(2.0 + mas_durations) * x_mask
        dur_loss = (F.huber_loss(logw, logw_target, reduction="none",
                                 delta=cfg.duration_loss_threshold) * w[:, None]).sum()
        dur_loss = dur_loss / dens[0]

        # ---- prior loss (fine resolution, fp32): a gather, not a path matmul ----
        gather_idx = idx.long().clamp(min=0)[:, :, None].expand(-1, -1, mu_x32.shape[-1])
        mu_y_fine = torch.gather(mu_x32, 1, gather_idx) * y_fine_mask[..., None]
        if cfg.prior_loss:
            m = y_fine_mask[..., None]
            prior_loss = (F.huber_loss(mu_y_fine * m, y_fine32 * m, reduction="none",
                                       delta=cfg.prior_loss_threshold) * w[:, None, None]).sum()
            prior_loss = prior_loss / dens[1]
        else:
            prior_loss = torch.zeros((), dtype=torch.float32, device=dev)

        # ---- CFM loss (coarse resolution, prior detached) ----
        mu_y = downsample_time(mu_y_fine)[:, : y.shape[1]].detach()
        estimator = self.decoder.estimator

        def velocity(xt, mask, mu, t):
            return estimator(xt, mask, mu, t, masked_norm=False, gen=drop)

        with annotate("matcha/train.cfm"):
            diff_loss = cfm_loss(velocity, y, y_mask, mu_y, generator,
                                 sigma_min=cfg.cfm.sigma_min, use_mu_prior=cfg.cfm.use_mu_prior,
                                 t_noise=cfm_t_noise, row_weights=w, denominator=dens[2], rows=rows)

        # abs-error quantiles, to tune the Huber thresholds (matcha_tts.py:166-182)
        with annotate("matcha/train.diagnostics"), torch.no_grad():
            dur_err = torch.where(x_mask > 0, (logw - logw_target).abs(), 0.0)
            prior_err = (mu_y_fine - y_fine32).abs() * y_fine_mask[..., None]
            diagnostics = {}
            for name, err in (("duration", dur_err), ("prior", prior_err)):
                for q, v in zip(QUANTILES, linear_quantiles(err)):
                    diagnostics[f"abs_error_quantiles/{name}_{q}"] = v

        return {
            "diff_loss": diff_loss,
            "dur_loss": dur_loss,
            "prior_loss": prior_loss,
            "loss": diff_loss + dur_loss + prior_loss,
            "mas_frames": (mas_durations * x_mask).sum(),
            **diagnostics,
        }

    def encode(self, x, x_mask, spk_enc, spk_dur):
        """Text → (mu_x, raw durations in fine frames).

        exp(logw) - 2 undoes the training-time +2 shift (reference:
        matcha/inference.py:126-128).
        """
        mu_x, logw = self.encoder(x, x_mask, spk_enc, spk_dur)
        return mu_x, (torch.exp(logw) - 2.0) * x_mask

    def decode(self, mu_y, y_mask, n_timesteps: int, solver: str | None = None, *,
               noise: torch.Tensor | None = None, masked_norm: bool = True):
        """Prior → mel via the CFM ODE; GroupNorm statistics over valid
        frames by default (see the JAX package's ``decode``).  ``noise=None``
        starts every row from the default seed's row."""
        estimator = self.decoder.estimator

        def velocity(xt, mask, mu, t):
            return estimator(xt, mask, mu, t, masked_norm=masked_norm)

        return cfm_synthesise(
            velocity, mu_y, y_mask, n_timesteps, noise=noise,
            solver=solver or self.cfg.cfm.solver, use_mu_prior=self.cfg.cfm.use_mu_prior,
        )

    def speaker_embeddings(self, spks):
        return self.speaker_embeddings_enc(spks), self.speaker_embeddings_dur(spks)


def init_params(cfg: MatchaConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A random MatchaTTS state_dict (CPU, fp32) at any config."""
    return random_state_dict(MatchaTTS(cfg), generator)
