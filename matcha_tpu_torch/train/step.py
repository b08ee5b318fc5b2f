"""One training step: forward → backward → clip → AdamW, for either model.

The model is the class the config names (``cfg.model_class()``):
``MatchaConfig`` builds MatchaTTS (encoder + MAS + CFM; counterpart of
``matcha_tpu/train/step.py``), ``DiTConfig`` builds F5-TTS's DiT
(``models/dit.py``: text embedding, DiT, flow matching with infilling spans
and guidance drops), which the JAX package does not have.  The step asks
the class, never which model it is, for what differs: ``init_params``,
``batch_inputs`` (the batch fields it takes), ``step_kwargs`` (draws made
on the host: the DiT's guidance drops, counted in ``F5TTS.dropped``),
``METRICS`` (the losses it reports: MatchaTTS's four, the DiT's one),
``DROPOUT_WORDS`` and ``PARALLEL`` (the DiT trains on one device: data and
tensor parallelism raise); the weight-decay mask comes from its parameter
table (``weights.decay_mask``).  The state is a {name: tensor}
dict of parameters (leaf tensors that require grad), the optimizer's state
and the step count; the model module is a skeleton that
``torch.func.functional_call`` runs with those parameters, as a flax module
is applied to a parameter tree.  Each step draws CFM's t and noise (the
DiT: its spans, noise and t) from a ``torch.Generator`` seeded from
(seed, step), the counterpart of ``jax.random.fold_in(rng, state.step)``,
and its dropout masks from one seeded from (seed, step, rank) and the
model's ``DROPOUT_WORDS`` (MatchaTTS none, the DiT (2,)), as the JAX step
keeps dropout on a stream of its own (``fold_in(rng, 7)``).

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

Tensor parallelism (``mesh2d``, a ``parallel.sharding.Mesh2D``): the
ranks form a (dp, tp) grid.  The model's split pairs run on this rank's
blocks of their parameters (``parallel/sharding.py``), the state holds
those blocks (Adam's moments split alike), and the data-parallel rules
above apply over the data-parallel group: each data index d holds a
block of rows, which its tensor-parallel peers share; denominators and
gradients are summed over the data-parallel group; dropout draws from
(seed, step, d), the data index, so that tensor-parallel peers draw the
same masks (under pure data parallelism d is the rank).  The gradients
of replicated parameters are averaged over the tensor-parallel group, so
that their copies stay equal across peers on a card whose backward is not
bit-deterministic (equal inputs give equal values on the CPU).  The clip's
global norm sums the split gradients' squares over the tensor-parallel
group and counts the replicated ones once, so every rank clips by the
same norm and skips the same steps.  MAS runs on every rank, on its data
block's rows.  ``whole_state`` gathers the blocks into whole tensors for a
checkpoint; ``local_state`` slices whole ones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.func import functional_call

from matcha_tpu_torch.inference import resolve_device, strict_fp32
from matcha_tpu_torch.models.config import DiTConfig, MatchaConfig
from matcha_tpu_torch.models.layers import step_seed  # noqa: F401  (re-exported: the trainer, tools, tests)
from matcha_tpu_torch.parallel import mesh, sharding
from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig, OptState, global_norm
from matcha_tpu_torch.utils.profiling import annotate
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


class TrainStep:
    """The model skeleton, the optimizer and the two step functions."""

    def __init__(self, cfg: MatchaConfig | DiTConfig, opt_cfg: OptimizerConfig, device=None,
                 trainable: dict[str, bool] | None = None, data_parallel: bool = False,
                 mesh2d: sharding.Mesh2D | None = None):
        model_class = cfg.model_class()
        if not model_class.PARALLEL and (data_parallel or mesh2d is not None):
            raise ValueError(f"{model_class.__name__} trains on one device: data and tensor parallelism are "
                             "not ported for it (trainer.use_mesh=false, trainer.tensor_parallel=1)")
        self.device = resolve_device(device)
        strict_fp32(self.device)  # the log-prior product and the fp32 islands
        self.cfg = cfg
        self.model = model_class(cfg).to(self.device)
        self.mesh2d = mesh2d
        self.specs = None
        norm = None
        if mesh2d is not None:
            self.specs = sharding.tp_param_specs(self.model.state_dict(), cfg, mesh2d.tp)
            sharding.apply_tensor_parallel(
                self.model, self.specs, sharding.TPGroup(mesh2d.tp_group, mesh2d.tp, mesh2d.m))

            def norm(grads):
                return torch.sqrt(sharding.split_norm_sq(grads, self.specs, mesh2d))
        self.opt = AdamW(opt_cfg, decay_mask(cfg), trainable, norm=norm)
        self.data_parallel = data_parallel or mesh2d is not None
        if self.data_parallel and not mesh.active():
            raise RuntimeError("data_parallel needs a running process group (parallel.mesh.init_data_parallel)")
        # this process's data block (index, count) and the group its
        # losses and gradients are summed over (None: the whole group)
        if mesh2d is not None:
            self.data_index, self.data_size, self.dp_group = mesh2d.d, mesh2d.dp, mesh2d.dp_group
        elif self.data_parallel:
            self.data_index, self.data_size, self.dp_group = mesh.rank(), mesh.world(), None
        else:
            self.data_index, self.data_size, self.dp_group = 0, 1, None

    def init_state(self, params: dict[str, torch.Tensor] | None = None,
                   generator: torch.Generator | None = None) -> TrainState:
        """A fresh state from a state_dict, or random weights from ``generator``.
        Every leaf contiguous, as the card's optimizer takes them (a bridged
        state_dict holds transposed views)."""
        if params is None:
            params = self.model.init_params(self.cfg, generator or torch.Generator().manual_seed(0))
        p = {n: t.detach().to(self.device, torch.float32).clone(memory_format=torch.contiguous_format)
             .requires_grad_(True) for n, t in self.local_state(params).items()}
        return TrainState(p, self.opt.init(p), 0)

    def local_state(self, whole: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's blocks of whole tensors (all of them without
        tensor parallelism)."""
        if self.mesh2d is None:
            return dict(whole)
        return sharding.shard_state(whole, self.specs, self.mesh2d.tp, self.mesh2d.m)

    def local_opt_state(self, whole: OptState) -> OptState:
        """An optimizer state of whole tensors, sliced to this rank's blocks."""
        if self.mesh2d is None:
            return whole
        return dataclasses.replace(
            whole, mu=self.local_state(whole.mu), nu=self.local_state(whole.nu),
            acc_grads=None if whole.acc_grads is None else self.local_state(whole.acc_grads))

    def whole_state(self, state: TrainState) -> tuple[dict[str, torch.Tensor], OptState]:
        """(parameters, optimizer state) as whole tensors: the blocks
        gathered over the tensor-parallel group (collective: every rank
        calls it)."""
        if self.mesh2d is None:
            return state.params, state.opt_state
        opt = state.opt_state

        def whole(tensors):
            return sharding.gather_state(tensors, self.specs, self.mesh2d)

        return whole(state.params), dataclasses.replace(
            opt, mu=whole(opt.mu), nu=whole(opt.nu),
            acc_grads=None if opt.acc_grads is None else whole(opt.acc_grads))

    def grad_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients."""
        if self.opt.norm is None:
            return global_norm(grads.values())
        return self.opt.norm(grads)

    def _losses(self, params, batch: Batch, seed: int, dropout_seed: int, loss_kwargs):
        """The losses of this process's rows, on (seed)- and
        (dropout_seed)-seeded generators; under data parallelism, each
        rank's share of the global batch's losses."""
        if self.data_parallel:
            b = batch.x.shape[0]
            loss_kwargs = {"sum_over_ranks": lambda t: mesh.all_reduce_sum(t, self.dp_group),
                           "rows": (self.data_index * b, self.data_size * b), **loss_kwargs}
        return functional_call(
            self.model, params, (*self.model.batch_inputs(batch), self._generator(seed)),
            {"row_weights": batch.weights, "dropout_generator": self._generator(dropout_seed),
             **loss_kwargs},
        )

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _loss_metrics(self, losses) -> dict[str, torch.Tensor]:
        """The model's losses (MatchaTTS: four), summed over the group under
        data parallelism (each rank holds its share of the global batch's)."""
        keys, names = zip(*self.model.METRICS)
        parts = torch.stack([losses[k].detach() for k in keys])
        if self.data_parallel:
            parts = mesh.all_reduce_sum(parts, self.dp_group)
        return dict(zip(names, parts))

    def _dropout_seed(self, seed: int, step: int) -> int:
        """The seed of this rank's dropout masks at ``step``: (seed, step,
        rank) and the model's ``DROPOUT_WORDS``."""
        return step_seed(seed, step, self.data_index, *self.model.DROPOUT_WORDS)

    def train_step(self, state: TrainState, batch: Batch, seed: int, **loss_kwargs):
        """Updates ``state`` in place; returns it and the metrics (device
        scalars).  ``loss_kwargs`` (``deterministic``; MatchaTTS's
        ``cfm_t_noise``) pass to ``compute_losses``."""
        with annotate("matcha/train.step"):
            with annotate("matcha/train.forward"):
                loss_kwargs = {**self.model.step_kwargs(seed, state.step, count=True), **loss_kwargs}
                losses = self._losses(state.params, batch, step_seed(seed, state.step),
                                      self._dropout_seed(seed, state.step), loss_kwargs)
            with annotate("matcha/train.backward"):
                grads = self._grads(losses["loss"], state.params)
            with annotate("matcha/train.optimizer"):
                norm = self.opt.update(state.params, grads, state.opt_state)
            state.step += 1
            with annotate("matcha/train.metrics"):
                # the norm the clip read, where the update took one of these gradients
                grad_norm = self.grad_norm(grads) if norm is None else norm
                metrics = {**self._loss_metrics(losses), "grad_norm": grad_norm}
        return state, metrics

    def _grads(self, loss, params) -> dict[str, torch.Tensor]:
        """Every parameter's gradient of ``loss`` (zeros where unused),
        summed over the data-parallel group."""
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
        if self.data_parallel:
            mesh.all_reduce_sum_(list(grads.values()), self.dp_group)
        if self.mesh2d is not None and self.mesh2d.tp > 1:
            # a replicated parameter's gradient is the same on every
            # tensor-parallel peer in exact arithmetic; their mean keeps the
            # peers' copies equal where the card's backward is not
            # deterministic (the attention backward's atomic sums)
            replicated = [g for n, g in grads.items() if self.specs[n] is None]
            mesh.all_reduce_sum_(replicated, self.mesh2d.tp_group)
            for g in replicated:
                g.div_(self.mesh2d.tp)
        return grads

    @torch.no_grad()
    def eval_step(self, params, batch: Batch, seed: int, **loss_kwargs):
        """Losses without an update.  Dropout stays on, as in the JAX
        package's ``eval_step`` (it passes no ``deterministic``)."""
        loss_kwargs = {**self.model.step_kwargs(seed, 0, count=False), **loss_kwargs}
        losses = self._losses(params, batch, seed, self._dropout_seed(seed, 0), loss_kwargs)
        return self._loss_metrics(losses)


def make_train_step(cfg: MatchaConfig | DiTConfig, opt_cfg: OptimizerConfig, device=None,
                    trainable: dict[str, bool] | None = None):
    """(train_step, eval_step) on ``device`` (the card unless "cpu" is asked for).

    ``train_step(state, batch, seed)`` → (state, metrics);
    ``eval_step(params, batch, seed)`` → metrics.
    """
    ts = TrainStep(cfg, opt_cfg, device, trainable)
    return ts.train_step, ts.eval_step
