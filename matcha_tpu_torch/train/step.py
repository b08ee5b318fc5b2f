"""One training step: forward (encoder + MAS + CFM) → backward → clip → AdamW.

Counterpart of ``matcha_tpu/train/step.py`` on one device.  The state is a
{name: tensor} dict of parameters (leaf tensors that require grad), the
optimizer's state and the step count; the model module is a skeleton that
``torch.func.functional_call`` runs with those parameters, as a flax module
is applied to a parameter tree.  Each step draws its dropout masks and
CFM's t and noise from a ``torch.Generator`` seeded from (seed, step), the
counterpart of ``jax.random.fold_in(rng, state.step)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from matcha_tpu_torch.inference import resolve_device, strict_fp32
from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.models.matcha import MatchaTTS, init_params
from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig, OptState, global_norm
from matcha_tpu_torch.weights import decay_mask


class Batch(NamedTuple):
    """One padded, bucketed training batch (tensors on one device)."""

    x: torch.Tensor               # (B, Tx) int phoneme ids
    x_lengths: torch.Tensor       # (B,)
    y: torch.Tensor               # (B, Ty, C) coarse mel
    y_lengths: torch.Tensor       # (B,)
    y_fine: torch.Tensor          # (B, 2·Ty, C) fine mel
    y_fine_lengths: torch.Tensor  # (B,)
    spks: torch.Tensor            # (B,)
    # (B,) loss weights, 0 on repeat-filled rows; None means all ones
    weights: torch.Tensor | None = None

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return Batch(*(None if t is None else t.to(device, non_blocking=non_blocking)
                       for t in self))


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: OptState
    step: int = 0


def step_seed(seed: int, step: int) -> int:
    """A generator seed for step ``step`` of a run seeded with ``seed``."""
    words = np.random.SeedSequence([seed, step]).generate_state(2, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1])


class TrainStep:
    """The model skeleton, the optimizer and the two step functions."""

    def __init__(self, cfg: MatchaConfig, opt_cfg: OptimizerConfig, device=None,
                 trainable: dict[str, bool] | None = None):
        self.device = resolve_device(device)
        strict_fp32(self.device)  # the log-prior product and the fp32 islands
        self.cfg = cfg
        self.model = MatchaTTS(cfg).to(self.device)
        self.opt = AdamW(opt_cfg, decay_mask(cfg), trainable)

    def init_state(self, params: dict[str, torch.Tensor] | None = None,
                   generator: torch.Generator | None = None) -> TrainState:
        """A fresh state from a state_dict, or random weights from ``generator``."""
        if params is None:
            params = init_params(self.cfg, generator or torch.Generator().manual_seed(0))
        p = {n: t.detach().to(self.device, torch.float32).clone().requires_grad_(True)
             for n, t in params.items()}
        return TrainState(p, self.opt.init(p), 0)

    def _losses(self, params, batch: Batch, generator, loss_kwargs):
        return functional_call(
            self.model, params,
            (batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.y_fine,
             batch.y_fine_lengths, batch.spks, generator),
            {"row_weights": batch.weights, **loss_kwargs},
        )

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_step(self, state: TrainState, batch: Batch, seed: int, **loss_kwargs):
        """Updates ``state`` in place; returns it and the metrics (device
        scalars).  ``loss_kwargs`` (``deterministic``, ``cfm_t_noise``) pass
        to ``compute_losses``."""
        gen = self._generator(step_seed(seed, state.step))
        losses = self._losses(state.params, batch, gen, loss_kwargs)
        names = list(state.params)
        grads = torch.autograd.grad(losses["loss"], [state.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(state.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        self.opt.update(state.params, grads, state.opt_state)
        state.step += 1
        metrics = {
            "loss": losses["loss"].detach(),
            "sub_loss/diff": losses["diff_loss"].detach(),
            "sub_loss/dur": losses["dur_loss"].detach(),
            "sub_loss/prior": losses["prior_loss"].detach(),
            "grad_norm": global_norm(grads.values()),
        }
        return state, metrics

    @torch.no_grad()
    def eval_step(self, params, batch: Batch, seed: int, **loss_kwargs):
        """Losses without an update.  Dropout stays on, as in the JAX
        package's ``eval_step`` (it passes no ``deterministic``)."""
        losses = self._losses(params, batch, self._generator(seed), loss_kwargs)
        return {
            "loss": losses["loss"],
            "sub_loss/diff": losses["diff_loss"],
            "sub_loss/dur": losses["dur_loss"],
            "sub_loss/prior": losses["prior_loss"],
        }


def make_train_step(cfg: MatchaConfig, opt_cfg: OptimizerConfig, device=None,
                    trainable: dict[str, bool] | None = None):
    """(train_step, eval_step) on ``device`` (the card unless "cpu" is asked for).

    ``train_step(state, batch, seed)`` → (state, metrics);
    ``eval_step(params, batch, seed)`` → metrics.
    """
    ts = TrainStep(cfg, opt_cfg, device, trainable)
    return ts.train_step, ts.eval_step
