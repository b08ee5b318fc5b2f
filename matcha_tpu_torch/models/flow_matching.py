"""Optimal-transport conditional flow matching: training loss and synthesis.

PyTorch counterpart of ``matcha_tpu/models/flow_matching.py``: the masked
OT-CFM training loss ``cfm_loss``, fixed-grid ODE solvers (euler /
midpoint / rk4 with Kutta's 3/8 rule / heun3) and ``cfm_synthesise``,
integrating dx/dt = v(x, t | mu) from t=0 to 1 starting at z = mu + noise.

Noise.  The JAX package draws its seeded noise with threefry, which torch
cannot reproduce, so the port's seeded audio is not bit-equal to the JAX
package's.  It keeps the same invariance: one (T, C) row shared by every
batch row, its value at (t, c) independent of the mel bucket — the
synthesizer draws the row once at the largest bucket and slices it.  Tests
pass the JAX draw in through the explicit ``noise`` argument.
"""

from __future__ import annotations

from typing import Callable

import torch

DEFAULT_NOISE_SEED = 42

SOLVERS = ("euler", "midpoint", "rk4", "heun3")


def _step_euler(f, x, t, dt):
    return x + dt * f(x, t)


def _step_midpoint(f, x, t, dt):
    k1 = f(x, t)
    return x + dt * f(x + 0.5 * dt * k1, t + 0.5 * dt)


def _step_rk4(f, x, t, dt):
    """Kutta's 3/8-rule RK4 (what torchdiffeq runs for method="rk4")."""
    k1 = f(x, t)
    k2 = f(x + (dt / 3.0) * k1, t + dt / 3.0)
    k3 = f(x + dt * (k2 - k1 / 3.0), t + 2.0 * dt / 3.0)
    k4 = f(x + dt * (k1 - k2 + k3), t + dt)
    return x + dt * (k1 + 3.0 * (k2 + k3) + k4) / 8.0


def _step_heun3(f, x, t, dt):
    k1 = f(x, t)
    k2 = f(x + (dt / 3.0) * k1, t + dt / 3.0)
    k3 = f(x + (2.0 * dt / 3.0) * k2, t + 2.0 * dt / 3.0)
    return x + (dt / 4.0) * (k1 + 3.0 * k3)


_STEPS = {
    "euler": _step_euler,
    "midpoint": _step_midpoint,
    "rk4": _step_rk4,
    "heun3": _step_heun3,
}


def odeint_fixed(f: Callable, x0: torch.Tensor, t_span: torch.Tensor,
                 solver: str = "midpoint") -> torch.Tensor:
    """Integrate dx/dt = f(x, t) over the grid ``t_span``; final state only."""
    if solver not in _STEPS:
        raise ValueError(f"Unknown solver {solver!r}; choose from {SOLVERS}")
    step = _STEPS[solver]
    x = x0
    for i in range(t_span.shape[0] - 1):
        t = t_span[i]
        x = step(f, x, t, t_span[i + 1] - t)
    return x


def cfm_loss(estimator: Callable, x1: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor,
             generator: torch.Generator | None, *, sigma_min: float = 1e-4,
             use_mu_prior: bool = True, t_noise=None,
             row_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Masked OT-CFM loss (reference: flow_matching.py:65-112).

    ``estimator(x, mask, mu, t)`` → velocity; x1, mu: (B, T, C), mu already
    detached by the caller; mask (B, T).  t ~ U[0, 1) per row and the noise
    are drawn from ``generator`` unless ``t_noise`` = ((B, 1, 1) t,
    (B, T, C) noise) fixes them (the cross-framework parity hook).
    ``row_weights`` (B,) weights each row's squared error (0 excludes a
    repeat-filled row); the estimator still sees the binary mask.
    """
    b = x1.shape[0]
    if t_noise is not None:
        t, noise = t_noise
    elif generator is None:
        raise ValueError("cfm_loss needs a generator or a fixed t_noise")
    else:
        t = torch.rand((b, 1, 1), generator=generator, device=x1.device, dtype=x1.dtype)
        noise = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
    x0 = mu + noise if use_mu_prior else noise
    y = (1.0 - (1.0 - sigma_min) * t) * x0 + t * x1
    u = x1 - (1.0 - sigma_min) * x0

    pred = estimator(y, mask, mu, t[:, 0, 0])
    m = mask[..., None]
    sq = torch.square((pred - u) * m)
    if row_weights is None:
        return sq.sum() / (m.sum() * x1.shape[-1])
    w = row_weights[:, None, None]
    return (sq * w).sum() / ((m * w).sum() * x1.shape[-1])


def synthesis_noise_row(t: int, c: int, seed: int = DEFAULT_NOISE_SEED) -> torch.Tensor:
    """(t, c) fp32 standard-normal row from a seeded CPU ``torch.Generator``.

    Slicing the first rows of a longer draw gives the noise of a shorter
    bucket, so draw once at the largest bucket.
    """
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((t, c), generator=gen, dtype=torch.float32)


def cfm_synthesise(estimator: Callable, mu: torch.Tensor, mask: torch.Tensor,
                   n_timesteps: int, *, noise: torch.Tensor,
                   solver: str = "midpoint", use_mu_prior: bool = True) -> torch.Tensor:
    """ODE synthesis from the prior (reference: flow_matching.py:26-63).

    ``estimator(x, mask, mu, t)`` → velocity; ``noise`` is (B, T, C).
    """
    z = mu + noise if use_mu_prior else noise
    z = z * mask[..., None]
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=mu.dtype, device=mu.device)

    def f(x, t):
        return estimator(x, mask, mu, t)

    return odeint_fixed(f, z, t_span, solver=solver)
