"""Port parity: the text encoder's mu_x and logw vs the JAX TextEncoder.

tiny_config, fp32, bridged weights, numpy-seeded ids and speaker vectors;
JAX on the CPU runs attention through its einsum path.  Tolerance 1e-4:
fp32 through ~10 layers of convs and norms, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.text_encoder import apply_rope as jax_apply_rope
from matcha_tpu.models.text_encoder import rope_cache as jax_rope_cache
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.models.text_encoder import apply_rope, rope_cache
from matcha_tpu_torch.weights import params_from_jax


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    port = MatchaTTS(tiny_config())
    port.load_state_dict(params_from_jax(params, tiny_config()))
    return params, port.eval()


def _inputs(seed, b=3, tx=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 600, size=(b, tx))
    lengths = np.array([tx, 9, 1][:b])
    mask = (np.arange(tx)[None] < lengths[:, None]).astype(np.float32)
    spk_enc = rng.standard_normal((b, 8)).astype(np.float32)
    spk_dur = rng.standard_normal((b, 8)).astype(np.float32)
    return ids, mask, spk_enc, spk_dur


@pytest.mark.parametrize("seed", [0, 1])
def test_mu_x_and_logw(models, seed):
    params, port = models
    ids, mask, spk_enc, spk_dur = _inputs(seed)
    ref_mu, ref_logw = JaxMatchaTTS(jax_tiny_config()).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(spk_enc), jnp.asarray(spk_dur), method=JaxMatchaTTS.encoder_forward,
    )
    with torch.no_grad():
        mu, logw = port.encoder(*map(torch.from_numpy, (ids, mask, spk_enc, spk_dur)))
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logw.numpy(), np.asarray(ref_logw), atol=1e-4, rtol=1e-4)


def test_encode_durations(models):
    params, port = models
    ids, mask, spk_enc, spk_dur = _inputs(2)
    _, ref = JaxMatchaTTS(jax_tiny_config()).apply(
        {"params": params}, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        jnp.asarray(spk_enc), jnp.asarray(spk_dur), method=JaxMatchaTTS.encode,
    )
    with torch.no_grad():
        _, dur = port.encode(*map(torch.from_numpy, (ids, mask, spk_enc, spk_dur)))
    np.testing.assert_allclose(dur.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_rope_matches():
    cos, sin = rope_cache(32, 6)
    jcos, jsin = jax_rope_cache(32, 6)
    np.testing.assert_array_equal(cos, jcos)
    x = np.random.default_rng(0).standard_normal((2, 3, 10, 12)).astype(np.float32)
    ours = apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin), 6).numpy()
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(jcos), jnp.asarray(jsin), 6))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
