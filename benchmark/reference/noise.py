"""The synthesis noise row: ``jax.random.normal(PRNGKey(42), (T, C))``.

The served system starts every ODE from this seeded row (the first T rows
of one long draw), so the reference works the same row out again here:
threefry-2x32 over partitionable counters gives the bits, and XLA's fp32
``erf_inv`` polynomial turns their uniforms into normals.  Plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_NOISE_SEED = 42

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
