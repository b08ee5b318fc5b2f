"""One training step: forward (encoder + MAS + CFM) → backward → clip → AdamW.

Counterpart of ``matcha_tpu/train/step.py``.  The state is a {name: tensor}
dict of parameters (leaf tensors that require grad), the optimizer's state
and the step count; the model module is a skeleton that
``torch.func.functional_call`` runs with those parameters, as a flax module
is applied to a parameter tree.  Each step draws CFM's t and noise from a
``torch.Generator`` seeded from (seed, step), the counterpart of
``jax.random.fold_in(rng, state.step)``, and its dropout masks from one
seeded from (seed, step, rank), as the JAX step keeps dropout on a stream
of its own (``fold_in(rng, 7)``).

Data parallelism (``data_parallel=True``, a process group running; see
``parallel/mesh.py``): each rank holds a contiguous block of the global
batch's rows.  The three loss denominators are summed over the group
before they divide, CFM's t and noise are drawn at the global shape and
sliced, and the gradients are summed over the group before the clip and
the finite check, so every rank's gradient is the global batch's, every
rank clips by the same norm and skips the same steps, and the parameters
and optimizer state stay bit-identical across ranks.  At dropout 0 a step
equals the single-process step on the whole batch; with dropout the masks
differ from a single process's (each rank draws its own from its rank's
generator, where the JAX step draws them for the global batch).
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
from matcha_tpu_torch.parallel import mesh
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


def step_seed(seed: int, step: int, *more: int) -> int:
    """A generator seed for step ``step`` of a run seeded with ``seed``
    (and ``more``, e.g. a rank)."""
    words = np.random.SeedSequence([seed, step, *more]).generate_state(2, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1])


class TrainStep:
    """The model skeleton, the optimizer and the two step functions."""

    def __init__(self, cfg: MatchaConfig, opt_cfg: OptimizerConfig, device=None,
                 trainable: dict[str, bool] | None = None, data_parallel: bool = False):
        self.device = resolve_device(device)
        strict_fp32(self.device)  # the log-prior product and the fp32 islands
        self.cfg = cfg
        self.model = MatchaTTS(cfg).to(self.device)
        self.opt = AdamW(opt_cfg, decay_mask(cfg), trainable)
        self.data_parallel = data_parallel
        if data_parallel and not mesh.active():
            raise RuntimeError("data_parallel needs a running process group (parallel.mesh.init_data_parallel)")

    def init_state(self, params: dict[str, torch.Tensor] | None = None,
                   generator: torch.Generator | None = None) -> TrainState:
        """A fresh state from a state_dict, or random weights from ``generator``."""
        if params is None:
            params = init_params(self.cfg, generator or torch.Generator().manual_seed(0))
        p = {n: t.detach().to(self.device, torch.float32).clone().requires_grad_(True)
             for n, t in params.items()}
        return TrainState(p, self.opt.init(p), 0)

    def _losses(self, params, batch: Batch, seed: int, dropout_seed: int, loss_kwargs):
        """The losses of this process's rows, on (seed)- and
        (dropout_seed)-seeded generators; under data parallelism, each
        rank's share of the global batch's losses."""
        if self.data_parallel:
            b = batch.x.shape[0]
            loss_kwargs = {"sum_over_ranks": mesh.all_reduce_sum,
                           "rows": (mesh.rank() * b, mesh.world() * b), **loss_kwargs}
        return functional_call(
            self.model, params,
            (batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.y_fine,
             batch.y_fine_lengths, batch.spks, self._generator(seed)),
            {"row_weights": batch.weights, "dropout_generator": self._generator(dropout_seed),
             **loss_kwargs},
        )

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _loss_metrics(self, losses) -> dict[str, torch.Tensor]:
        """The four losses, summed over the group under data parallelism
        (each rank holds its share of the global batch's)."""
        parts = torch.stack([losses[k].detach() for k in ("loss", "diff_loss", "dur_loss", "prior_loss")])
        if self.data_parallel:
            parts = mesh.all_reduce_sum(parts)
        return dict(zip(("loss", "sub_loss/diff", "sub_loss/dur", "sub_loss/prior"), parts))

    def train_step(self, state: TrainState, batch: Batch, seed: int, **loss_kwargs):
        """Updates ``state`` in place; returns it and the metrics (device
        scalars).  ``loss_kwargs`` (``deterministic``, ``cfm_t_noise``) pass
        to ``compute_losses``."""
        rank = mesh.rank() if self.data_parallel else 0
        losses = self._losses(state.params, batch, step_seed(seed, state.step),
                              step_seed(seed, state.step, rank), loss_kwargs)
        names = list(state.params)
        grads = torch.autograd.grad(losses["loss"], [state.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(state.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        if self.data_parallel:
            mesh.all_reduce_sum_(list(grads.values()))
        self.opt.update(state.params, grads, state.opt_state)
        state.step += 1
        metrics = {**self._loss_metrics(losses), "grad_norm": global_norm(grads.values())}
        return state, metrics

    @torch.no_grad()
    def eval_step(self, params, batch: Batch, seed: int, **loss_kwargs):
        """Losses without an update.  Dropout stays on, as in the JAX
        package's ``eval_step`` (it passes no ``deterministic``)."""
        rank = mesh.rank() if self.data_parallel else 0
        losses = self._losses(params, batch, seed, step_seed(seed, 0, rank), loss_kwargs)
        return self._loss_metrics(losses)


def make_train_step(cfg: MatchaConfig, opt_cfg: OptimizerConfig, device=None,
                    trainable: dict[str, bool] | None = None):
    """(train_step, eval_step) on ``device`` (the card unless "cpu" is asked for).

    ``train_step(state, batch, seed)`` → (state, metrics);
    ``eval_step(params, batch, seed)`` → metrics.
    """
    ts = TrainStep(cfg, opt_cfg, device, trainable)
    return ts.train_step, ts.eval_step
