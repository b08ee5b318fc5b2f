"""Optimal-transport conditional flow matching: training loss and synthesis.

PyTorch counterpart of ``matcha_tpu/models/flow_matching.py``: the masked
OT-CFM training loss ``cfm_loss``, fixed-grid ODE solvers (euler /
midpoint / rk4 with Kutta's 3/8 rule / heun3) and ``cfm_synthesise``,
integrating dx/dt = v(x, t | mu) from t=0 to 1 starting at z = mu + noise.

Noise.  ``seeded_synthesis_noise`` reproduces the JAX package's seeded
draw, ``jax.random.normal(PRNGKey(seed), (T, C))``: threefry-2x32 over
partitionable counters gives the same bits, and XLA's fp32 ``erf_inv``
polynomial turns their uniforms into normals within a few ulp, so the same
text at the same seed gives the same audio in both packages.  The row is
shared by every batch row and its value at (t, c) depends on neither the
batch nor the mel bucket (the counter is the flat index t·C + c), so the
synthesizer draws it once at the largest bucket and slices it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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
             row_weights: torch.Tensor | None = None,
             denominator: torch.Tensor | None = None,
             rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Masked OT-CFM loss (reference: flow_matching.py:65-112).

    ``estimator(x, mask, mu, t)`` → velocity; x1, mu: (B, T, C), mu already
    detached by the caller; mask (B, T).  t ~ U[0, 1) per row and the noise
    are drawn from ``generator`` unless ``t_noise`` = ((B, 1, 1) t,
    (B, T, C) noise) fixes them (the cross-framework parity hook).
    ``row_weights`` (B,) weights each row's squared error (0 excludes a
    repeat-filled row); the estimator still sees the binary mask.

    Data parallelism: ``rows`` = (first row, global rows) draws t and the
    noise at the global batch's shape and takes this block's rows, and
    ``denominator`` replaces the local Σ mask·w·C by the global one.
    """
    b = x1.shape[0]
    if t_noise is not None:
        t, noise = t_noise
    elif generator is None:
        raise ValueError("cfm_loss needs a generator or a fixed t_noise")
    else:
        first, total = rows if rows is not None else (0, b)
        t = torch.rand((total, 1, 1), generator=generator, device=x1.device, dtype=x1.dtype)
        noise = torch.randn((total,) + tuple(x1.shape[1:]), generator=generator,
                            device=x1.device, dtype=x1.dtype)
        t, noise = t[first:first + b], noise[first:first + b]
    x0 = mu + noise if use_mu_prior else noise
    y = (1.0 - (1.0 - sigma_min) * t) * x0 + t * x1
    u = x1 - (1.0 - sigma_min) * x0

    pred = estimator(y, mask, mu, t[:, 0, 0])
    m = mask[..., None]
    sq = torch.square((pred - u) * m)
    if row_weights is None:
        return sq.sum() / (m.sum() * x1.shape[-1] if denominator is None else denominator)
    w = row_weights[:, None, None]
    return (sq * w).sum() / ((m * w).sum() * x1.shape[-1] if denominator is None else denominator)


# threefry-2x32, 20 rounds (Random123's rotation constants), as jax._src.prng
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's fp32 erf_inv (Giles' single-precision form), for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 block cipher on uint32 counter words ``(x0, x1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_bits(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)`` in partitionable
    mode: the key is (seed >> 32, seed & 0xFFFFFFFF) with 32-bit seeds, the
    counter of element n its (hi, lo) words, the bits the XOR of both
    outputs."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi, lo = (n >> np.uint64(32)).astype(np.uint32), (n & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32((0, int(seed) & 0xFFFFFFFF), hi, lo)
    return (b0 ^ b1).reshape(shape)


def erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's fp32 ``erf_inv``: a degree-8 polynomial in w − 2.5 (w < 5) or
    sqrt(w) − 3, with w = −log1p(−x²), times x; ±1 map to ±inf.  log1p and
    the multiply-adds round once each, as the fused kernel does."""
    f32, f64 = np.float32, np.float64
    with np.errstate(divide="ignore"):
        w = (-np.log1p(-(x * x).astype(f64))).astype(f32)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0])).astype(f32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, f32(a), f32(b)).astype(f32)
        p = (c.astype(f64) + p.astype(f64) * w.astype(f64)).astype(f32)
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x).astype(f32)


def seeded_synthesis_noise(t: int, c: int, seed: int = DEFAULT_NOISE_SEED) -> torch.Tensor:
    """The (t, c) fp32 row of ``jax.random.normal(PRNGKey(seed), (t, c))``
    (the JAX package's ``seeded_synthesis_noise``), on the CPU.

    The bits are threefry's exactly; the uniform is ``jax.random.uniform``'s
    (23 mantissa bits OR 1.0 → [1, 2), then onto (nextafter(−1, +inf), 1));
    the normal is sqrt(2)·erf_inv(u).  Row t of a longer draw equals row t
    of a shorter one, so a bucket of T frames takes the first T rows.
    """
    f32 = np.float32
    bits = threefry_bits(seed, (t, c))
    unit = ((bits >> np.uint32(9)) | f32(1.0).view(np.uint32)).view(f32) - f32(1.0)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = np.maximum(lo, unit * (f32(1.0) - lo) + lo).astype(f32)
    return torch.from_numpy((f32(np.sqrt(2.0)) * erf_inv_f32(u)).astype(f32))


def cfm_synthesise(estimator: Callable, mu: torch.Tensor, mask: torch.Tensor,
                   n_timesteps: int, *, solver: str = "midpoint", use_mu_prior: bool = True,
                   noise_seed: int = DEFAULT_NOISE_SEED,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """ODE synthesis from the prior (reference: flow_matching.py:26-63).

    ``estimator(x, mask, mu, t)`` → velocity.  ``noise`` (B, T, C)
    overrides the seeded draw; without it every batch row starts from the
    ``noise_seed`` row (``seeded_synthesis_noise``), as in the JAX package.
    """
    if noise is None:
        b, t, c = mu.shape
        row = seeded_synthesis_noise(t, c, noise_seed).to(mu.device, mu.dtype)
        noise = row[None].expand(b, t, c)
    z = mu + noise if use_mu_prior else noise
    z = z * mask[..., None]
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, dtype=mu.dtype, device=mu.device)

    def f(x, t):
        return estimator(x, mask, mu, t)

    return odeint_fixed(f, z, t_span, solver=solver)
