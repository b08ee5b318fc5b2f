"""Port parity: monotonic alignment search.

The plain version against the JAX scan (``maximum_path_indices``) and the
Pallas kernels in interpret mode (as tests/test_mas_pallas.py runs them on
the CPU): indices must be EQUAL, since both are fp32 adds and maxes in one
order.  Ragged random batches, x_len = 1, y_len = x_len (pure diagonal)
and an all-ties batch.  The dense path against the numpy oracle, and the
duration histogram.  The CUDA kernel against the plain version runs on the
card only (tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.mas import durations_from_indices as jax_durations
from matcha_tpu.ops.mas import maximum_path_indices as jax_mas
from matcha_tpu.ops.mas_pallas import maximum_path_indices_pallas
from matcha_tpu_torch.ops import mas


def _case(kind, seed, b=4, t_x=8, t_y=24):
    rng = np.random.default_rng(seed)
    v = -np.abs(rng.standard_normal((b, t_x, t_y))).astype(np.float32)
    x_len = rng.integers(1, t_x + 1, size=b)
    y_len = np.array([rng.integers(xl, t_y + 1) for xl in x_len])
    if kind == "x_len_1":
        x_len[:] = 1
    elif kind == "diagonal":
        y_len = x_len.copy()
    elif kind == "ties":
        v[:] = -1.0
    return v, x_len.astype(np.int32), y_len.astype(np.int32)


def _plain(v, x_len, y_len):
    return mas.maximum_path_indices_plain(*map(torch.from_numpy, (v, x_len, y_len))).numpy()


KINDS = ["ragged", "x_len_1", "diagonal", "ties"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_jax_scan(kind, seed):
    v, xl, yl = _case(kind, seed)
    ref = np.asarray(jax_mas(jnp.asarray(v), jnp.asarray(xl), jnp.asarray(yl)))
    np.testing.assert_array_equal(_plain(v, xl, yl), ref)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_pallas_interpret(kind):
    v, xl, yl = _case(kind, 5, b=3, t_x=11, t_y=37)
    ref = np.asarray(maximum_path_indices_pallas(
        jnp.asarray(v), jnp.asarray(xl), jnp.asarray(yl), interpret=True))
    np.testing.assert_array_equal(_plain(v, xl, yl), ref)


def test_dense_path_matches_numpy_oracle():
    rng = np.random.default_rng(7)
    t_x, t_y = 6, 15
    v = -np.abs(rng.standard_normal((t_x, t_y))).astype(np.float32)
    path = mas.maximum_path(torch.from_numpy(v[None]), torch.tensor([t_x]), torch.tensor([t_y]))
    np.testing.assert_array_equal(path[0].numpy(), mas.maximum_path_numpy(v, t_x, t_y))


@pytest.mark.parametrize("backend", mas.BACKENDS)
def test_backends_agree_on_cpu(backend):
    v, xl, yl = _case("ragged", 1)
    got = mas.maximum_path_indices(*map(torch.from_numpy, (v, xl, yl)), backend=backend)
    np.testing.assert_array_equal(got.numpy(), _plain(v, xl, yl))


def test_unknown_backend_raises():
    v, xl, yl = map(torch.from_numpy, _case("ragged", 1))
    with pytest.raises(ValueError):
        mas.maximum_path_indices(v, xl, yl, backend="triton")


def test_durations_match_jax():
    v, xl, yl = _case("ragged", 2)
    idx = _plain(v, xl, yl)
    ours = mas.durations_from_indices(torch.from_numpy(idx), v.shape[1]).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_durations(jnp.asarray(idx), v.shape[1])))
    np.testing.assert_array_equal(ours.sum(axis=1), yl)


def test_cpu_tensor_takes_plain_version_without_launch():
    v, xl, yl = map(torch.from_numpy, _case("ragged", 3))
    before = mas.mas_count.launches
    got = mas.maximum_path_indices_kernel(v, xl, yl)
    assert torch.equal(got, mas.maximum_path_indices_plain(v, xl, yl))
    assert mas.mas_count.launches == before
