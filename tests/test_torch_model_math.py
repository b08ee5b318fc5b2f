"""Port parity: matcha_tpu_torch.utils.model_math vs matcha_tpu's JAX math.

Same numpy-seeded inputs through both; integer/boolean results must match
exactly, float results to 1e-6 (both sides compute in fp32 on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.utils import model_math as jm
from matcha_tpu_torch.utils import model_math as tm


@pytest.mark.parametrize("seed", [0, 1])
def test_sequence_mask(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 12, size=5)
    ours = tm.sequence_mask(torch.from_numpy(lengths), 12).numpy()
    ref = np.asarray(jm.sequence_mask(jnp.asarray(lengths), 12))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("n,k", [(1, 1), (3, 1), (100, 1), (101, 1), (5, 2), (17, 3)])
def test_fix_len_compatibility(n, k):
    assert tm.fix_len_compatibility(n, k) == jm.fix_len_compatibility(n, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_path(seed):
    rng = np.random.default_rng(seed)
    dur = rng.integers(0, 4, size=(3, 7))
    t_y = int(dur.sum(axis=1).max()) + 2
    mask = (rng.random((3, 7, t_y)) > 0.2).astype(np.float32)
    ours = tm.generate_path(torch.from_numpy(dur), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jm.generate_path(jnp.asarray(dur), jnp.asarray(mask)))
    np.testing.assert_array_equal(ours, ref)


def test_normalize_roundtrip():
    x = np.random.default_rng(0).standard_normal((2, 5, 3)).astype(np.float32)
    n = tm.normalize(torch.from_numpy(x), -4.7, 6.5)
    np.testing.assert_allclose(n.numpy(), np.asarray(jm.normalize(jnp.asarray(x), -4.7, 6.5)), atol=1e-6)
    np.testing.assert_allclose(
        tm.denormalize(n, -4.7, 6.5).numpy(),
        np.asarray(jm.denormalize(jm.normalize(jnp.asarray(x), -4.7, 6.5), -4.7, 6.5)),
        atol=1e-6,
    )


@pytest.mark.parametrize("t", [2, 7, 16, 33])
def test_downsample_time(t):
    # odd T pads one more frame on the right; edge windows divide by 3
    x = np.random.default_rng(t).standard_normal((2, t, 4)).astype(np.float32)
    ours = tm.downsample_time(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.downsample_time(jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, (t + 1) // 2, 4)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
