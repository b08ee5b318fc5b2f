"""Port parity: the fixed-grid ODE solvers and cfm_synthesise vs JAX.

A linear-plus-forcing velocity field, written once in jnp and once in
torch, through all four solvers; then the real tiny U-Net through
``decode`` with the JAX noise passed in explicitly.  Tolerances: 1e-5 for
the toy field (fp32 arithmetic in another order), 2e-4 for the U-Net
(fp32, eight evaluations of ~20 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models import flow_matching as jfm
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu_torch.models import flow_matching as tfm
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.weights import params_from_jax

RNG = np.random.default_rng(0)
A = (RNG.standard_normal((6, 6)) * 0.3).astype(np.float32)
C = RNG.standard_normal(6).astype(np.float32)
X0 = RNG.standard_normal((2, 6)).astype(np.float32)


@pytest.mark.parametrize("solver", tfm.SOLVERS)
@pytest.mark.parametrize("steps", [1, 4, 7])
def test_solvers_match(solver, steps):
    def f_jax(x, t):
        return x @ jnp.asarray(A) + jnp.sin(3.0 * t) * jnp.asarray(C)

    def f_torch(x, t):
        return x @ torch.from_numpy(A) + torch.sin(3.0 * t) * torch.from_numpy(C)

    ref = jfm.odeint_fixed(f_jax, jnp.asarray(X0), jnp.linspace(0.0, 1.0, steps + 1), solver)
    ours = tfm.odeint_fixed(f_torch, torch.from_numpy(X0), torch.linspace(0.0, 1.0, steps + 1), solver)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_unknown_solver_raises():
    with pytest.raises(ValueError):
        tfm.odeint_fixed(lambda x, t: x, torch.zeros(2), torch.linspace(0, 1, 3), "dopri5")


def test_noise_row_slices_are_bucket_invariant():
    long = tfm.seeded_synthesis_noise(64, 8)
    assert torch.equal(tfm.seeded_synthesis_noise(64, 8), long)
    assert torch.equal(tfm.seeded_synthesis_noise(16, 8), long[:16])
    assert long.dtype == torch.float32 and long.shape == (64, 8)


@pytest.mark.parametrize("solver", ["midpoint", "rk4"])
def test_decode_with_injected_noise(solver):
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    port = MatchaTTS(tiny_config())
    port.load_state_dict(params_from_jax(params, tiny_config()))
    port.eval()  # the decoder's dropout is off at inference
    rng = np.random.default_rng(1)
    b, frames, c = 2, 16, 8
    mu = rng.standard_normal((b, frames, c)).astype(np.float32)
    mask = (np.arange(frames)[None] < np.array([[frames], [9]])).astype(np.float32)
    noise = np.array(jfm.seeded_synthesis_noise(b, frames, c))
    ref = JaxMatchaTTS(jax_tiny_config()).apply(
        {"params": params}, jnp.asarray(mu), jnp.asarray(mask), 2, solver, jnp.asarray(noise),
        method=JaxMatchaTTS.decode,
    )
    with torch.no_grad():
        ours = port.decode(torch.from_numpy(mu), torch.from_numpy(mask), 2, solver,
                           noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
