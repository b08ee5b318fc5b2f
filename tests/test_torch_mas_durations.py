"""The port's segment DP (``maximum_path_durations``) against the JAX package's.

Bit-equal durations on the cases of ``tests/test_mas.py`` (ragged lengths,
padding tokens 0, frames partitioned) and on a larger batch of continuous
values.  Against the frame DP (``maximum_path_indices`` →
``durations_from_indices``, which the MAS kernel equals on the card): equal
where no two paths tie and every sum is exact in fp32 (values on a 2⁻¹²
grid); with unrounded values the two DPs round their sums differently and
may part on a near-tie, which the JAX package allows ("ties may resolve to
a different — equally optimal — path").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.mas import maximum_path_durations as jax_durations
from matcha_tpu_torch.ops.mas import (
    durations_from_indices,
    maximum_path_durations,
    maximum_path_indices_plain,
)


def both(v, x_len, y_len):
    ref = np.asarray(jax_durations(jnp.asarray(v), jnp.asarray(x_len), jnp.asarray(y_len)))
    got = maximum_path_durations(torch.from_numpy(v), torch.from_numpy(np.asarray(x_len)),
                                 torch.from_numpy(np.asarray(y_len)))
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    return got.numpy(), ref


@pytest.mark.parametrize("seed", range(5))
def test_ragged_cases_equal_jax(seed):
    rng = np.random.default_rng(200 + seed)
    b, t_x, t_y = 4, 7, 19
    v = -np.abs(rng.standard_normal((b, t_x, t_y))).astype(np.float32)
    x_len = rng.integers(1, t_x + 1, size=b)
    y_len = np.array([rng.integers(xl, t_y + 1) for xl in x_len])
    got, ref = both(v, x_len, y_len)
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(axis=1) == y_len).all()


def test_padding_tokens_get_zero_and_frames_partition():
    rng = np.random.default_rng(42)
    v = -np.abs(rng.standard_normal((2, 5, 14))).astype(np.float32)
    got, ref = both(v, np.array([5, 3]), np.array([14, 9]))
    np.testing.assert_array_equal(got, ref)
    assert got[0].sum() == 14 and got[1].sum() == 9
    assert (got[0] >= 1).all() and (got[1][:3] >= 1).all() and (got[1][3:] == 0).all()


def test_ties_resolve_as_jax():
    """All-equal values: every path ties; both take the last argmax."""
    v = np.zeros((2, 4, 9), np.float32)
    got, ref = both(v, np.array([4, 2]), np.array([9, 5]))
    np.testing.assert_array_equal(got, ref)


def test_larger_batch_equals_jax():
    rng = np.random.default_rng(7)
    b, t_x, t_y = 8, 48, 200
    v = rng.standard_normal((b, t_x, t_y)).astype(np.float32)
    x_len = rng.integers(t_x // 2, t_x + 1, b)
    y_len = np.array([rng.integers(2 * x, t_y + 1) for x in x_len])
    got, ref = both(v, x_len, y_len)
    np.testing.assert_array_equal(got, ref)


def test_equals_the_frame_dp_on_exact_values():
    rng = np.random.default_rng(1)
    b, t_x, t_y = 8, 48, 200
    v = (np.round(rng.standard_normal((b, t_x, t_y)) * 2**12) / 2**12).astype(np.float32)
    x_len = rng.integers(t_x // 2, t_x + 1, b)
    y_len = np.array([rng.integers(2 * x, t_y + 1) for x in x_len])
    v, x_len, y_len = torch.from_numpy(v), torch.from_numpy(x_len), torch.from_numpy(y_len)
    idx = maximum_path_indices_plain(v, x_len, y_len)
    assert torch.equal(maximum_path_durations(v, x_len, y_len), durations_from_indices(idx, t_x).int())
