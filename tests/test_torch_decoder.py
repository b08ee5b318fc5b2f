"""Port parity: the CFM U-Net velocity vs the JAX Decoder.

tiny_config, fp32, bridged weights, masked GroupNorm statistics (what
``decode`` runs) and plain ones.  Tolerance 1e-4: fp32 through ~20 layers,
summed in another order.  Upsample1D alone pins the ConvTranspose layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.decoder import Upsample1D as JaxUpsample1D
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.decoder import Upsample1D
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.weights import params_from_jax


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    port = MatchaTTS(tiny_config())
    port.load_state_dict(params_from_jax(params, tiny_config()))
    return params, port.eval()


@pytest.mark.parametrize("masked_norm", [True, False])
@pytest.mark.parametrize("t", [0.0, 0.37])
def test_velocity(models, masked_norm, t):
    params, port = models
    rng = np.random.default_rng(int(t * 100) + masked_norm)
    b, frames, c = 3, 24, 8
    x = rng.standard_normal((b, frames, c)).astype(np.float32)
    mu = rng.standard_normal((b, frames, c)).astype(np.float32)
    lengths = np.array([frames, 13, 2])
    mask = (np.arange(frames)[None] < lengths[:, None]).astype(np.float32)
    tt = np.full((b,), t, np.float32)

    def run(m, *a):
        return m.decoder(*a, masked_norm=masked_norm)

    ref = JaxMatchaTTS(jax_tiny_config()).apply(
        {"params": params}, *map(jnp.asarray, (x, mask, mu, tt)), method=run
    )
    with torch.no_grad():
        ours = port.decoder.estimator(
            *map(torch.from_numpy, (x, mask, mu, tt)), masked_norm=masked_norm
        )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_masked_norm_is_bucket_invariant(models):
    # masked statistics: the valid frames do not see how much padding follows
    _, port = models
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32))
    mu = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32))
    mask = torch.ones((1, 16))
    pad = torch.zeros((1, 16, 8))
    with torch.no_grad():
        short = port.decoder.estimator(x, mask, mu, 0.5, masked_norm=True)
        long = port.decoder.estimator(
            torch.cat([x, pad], 1), torch.cat([mask, torch.zeros((1, 16))], 1),
            torch.cat([mu, pad], 1), 0.5, masked_norm=True,
        )
    np.testing.assert_allclose(long[:, :16].numpy(), short.numpy(), atol=1e-5)


def test_upsample1d_alone():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    mod = JaxUpsample1D(6)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["ConvTranspose_0"]["kernel"])  # (k, out, in)
    bias = np.asarray(variables["params"]["ConvTranspose_0"]["bias"])
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))
    up = Upsample1D(6)
    up.conv.weight.data = torch.tensor(np.transpose(kernel, (2, 1, 0)))
    up.conv.bias.data = torch.tensor(bias)
    with torch.no_grad():
        ours = up(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 10, 6)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
