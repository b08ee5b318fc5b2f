"""The optimizer, written out: global-norm clip → AdamW → skip non-finite → accumulate.

Counterpart of ``matcha_tpu/train/optim.py::build_optimizer``, computing
what its optax chain computes, step for step:

  clip_by_global_norm(grad_clip)   g ← g                 if ‖g‖ < clip
                                   g ← g / ‖g‖ · clip    otherwise
  adamw(b1, b2, eps, wd, mask)     mu ← (1−b1)·g + b1·mu;  nu ← (1−b2)·g² + b2·nu
                                   u = (mu/(1−b1^n)) / (sqrt(nu/(1−b2^n)) + eps)
                                   u ← u + wd·p on the decay mask;  p ← p − lr·u
  [trainable mask]                 u ← 0 on frozen parameters
  apply_if_finite(10)              a non-finite gradient leaves p and the moments
                                   as they were, until the 11th in a row
  MultiSteps(k)                    the running mean of k gradients goes through
                                   the chain on every k-th call

``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: the latter adds
1e-6 to the norm.  The weight-decay mask comes from ``weights.decay_mask``
(flax kernels decay; embeddings, norms, biases, SnakeBeta alpha/beta do
not), the reference's grouping (baselightningmodule.py:29-59).

State lives on the parameters' device; the finite check and the step count
are device tensors, so an update never waits for the device.  A gradient
whose global norm is not finite (a NaN or inf anywhere, or an overflow of
the squared sum) counts as non-finite.

Dispatch by device: parameters on a CUDA device go through the multi-tensor
kernels of ``ops/adamw.py`` (a fixed number of launches a step, the moments
and the device scalars updated in place); parameters on the CPU through
``AdamW.apply_plain``, the loop written out below, which is also the
kernels' plain twin.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch

from matcha_tpu_torch.ops.adamw import FusedAdamW


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-5
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    grad_clip: float = 4.0
    # apply the update every N steps, averaging gradients in between
    # (reference: accumulate_grad_batches, configs/trainer/default.yaml:29)
    accumulate_grad_batches: int = 1
    # skip updates on non-finite gradients instead of corrupting the state
    skip_nonfinite_updates: bool = True


MAX_CONSECUTIVE_ERRORS = 10


@dataclass
class OptState:
    """Adam's moments and counters, keyed by parameter name: every leaf of
    the optax chain's state (``train/checkpoint.py`` maps them onto its key
    paths)."""

    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: torch.Tensor            # applied Adam steps (int32, on device)
    notfinite_count: torch.Tensor  # consecutive non-finite gradients (int32)
    mini_step: int = 0             # position inside an accumulation window
    acc_grads: dict[str, torch.Tensor] | None = None
    # apply_if_finite's record: was the last gradient finite, how many were not
    last_finite: torch.Tensor | None = None     # bool, on device
    total_notfinite: torch.Tensor | None = None  # int32, on device
    gradient_step: int = 0         # MultiSteps' count of emitted (averaged) updates

    def __post_init__(self):
        dev = self.count.device
        if self.last_finite is None:
            self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        if self.total_notfinite is None:
            self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ Σ t²), optax's ``global_norm``."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """The chain above over a {name: parameter} dict; updates in place."""

    def __init__(self, cfg: OptimizerConfig, decay: Mapping[str, bool],
                 trainable: Mapping[str, bool] | None = None, norm=None):
        self.cfg = cfg
        self.decay = dict(decay)
        self.trainable = None if trainable is None else dict(trainable)
        # {name: gradient} → the global norm the clip and the finite check
        # read; None is ``global_norm`` (tensor parallelism passes the norm
        # of the whole, unsplit gradients)
        self.norm = norm
        self.fused = FusedAdamW(self.decay, self.trainable)

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        dev = next(iter(params.values())).device
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return OptState(
            mu=zeros,
            nu={n: z.clone() for n, z in zeros.items()},
            count=torch.zeros((), dtype=torch.int32, device=dev),
            notfinite_count=torch.zeros((), dtype=torch.int32, device=dev),
            acc_grads=({n: z.clone() for n, z in zeros.items()}
                       if self.cfg.accumulate_grad_batches > 1 else None),
        )

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
               state: OptState) -> torch.Tensor | None:
        """One call per training step: updates ``params`` and ``state`` in place.

        Returns the global norm of ``grads`` that the clip read, a device
        scalar; None under gradient accumulation, where the clip reads the
        mean of k gradients (on every k-th call) and no norm of ``grads``."""
        k = self.cfg.accumulate_grad_batches
        if k > 1:
            n_acc = state.mini_step
            for n, g in grads.items():
                acc = state.acc_grads[n]
                acc.add_((g.float() - acc) / (n_acc + 1))
            state.mini_step = (n_acc + 1) % k
            if state.mini_step != 0:
                return None
            state.gradient_step += 1
            self._apply(params, state.acc_grads, state)
            for acc in state.acc_grads.values():
                acc.mul_(0)  # as MultiSteps resets its accumulator: 0·acc
            return None
        return self._apply(params, grads, state)

    def _apply(self, params, grads, state: OptState) -> torch.Tensor:
        if next(iter(params.values())).is_cuda:
            norm = None if self.norm is None else self.norm(grads)
            return self.fused.step(params, grads, state, self.cfg, MAX_CONSECUTIVE_ERRORS, norm)
        return self.apply_plain(params, grads, state)

    def apply_plain(self, params, grads, state: OptState) -> torch.Tensor:
        """The chain as a loop over the parameters, on any device: the CPU's
        path and the kernels' plain twin.  Returns the norm it clipped by."""
        cfg = self.cfg
        names = list(params)
        g_norm = global_norm(grads[n] for n in names) if self.norm is None else self.norm(grads)
        clip = g_norm < cfg.grad_clip
        if cfg.skip_nonfinite_updates:
            finite = torch.isfinite(g_norm)
            notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                    state.notfinite_count + 1)
            accept = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
            state.notfinite_count = notfinite
            state.last_finite = finite
            state.total_notfinite = state.total_notfinite + (~finite).to(torch.int32)
        else:
            accept = torch.ones((), dtype=torch.bool, device=g_norm.device)
        count = state.count + accept.to(torch.int32)
        # (1 − b^n) in fp32, as optax computes it
        n_f = count.float()
        bc1 = 1.0 - torch.pow(torch.full_like(n_f, cfg.b1), n_f)
        bc2 = 1.0 - torch.pow(torch.full_like(n_f, cfg.b2), n_f)
        for n in names:
            p, g = params[n], grads[n].float()
            g = torch.where(clip, g, g / g_norm * cfg.grad_clip)
            mu = (1 - cfg.b1) * g + cfg.b1 * state.mu[n]
            nu = (1 - cfg.b2) * g**2 + cfg.b2 * state.nu[n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if self.decay[n]:
                u = u + cfg.weight_decay * p.float()
            u = -cfg.lr * u
            if self.trainable is not None and not self.trainable[n]:
                u = torch.zeros_like(u)
            p.copy_(torch.where(accept, p.float() + u, p.float()))
            state.mu[n] = torch.where(accept, mu, state.mu[n])
            state.nu[n] = torch.where(accept, nu, state.nu[n])
        state.count = count
        return g_norm
