"""Port parity: the synthesizer's seeded ODE noise against the JAX package's.

``matcha_tpu_torch.models.flow_matching.seeded_synthesis_noise`` against
``matcha_tpu.models.flow_matching.seeded_synthesis_noise`` at seeds 0, 42
and 1234, at the largest-bucket row (2048, 100) and a small odd one
(7, 80).  Tolerances: threefry's bits exactly equal to ``jax.random.bits``;
the normals within 4 ulp and 1e-6 absolute (XLA's fp32 ``log1p`` inside
``erf_inv`` is its own approximation; ≤ 3 ulp, 7.2e-7 on the CPU).  Then the
fused audio with no ``noise`` passed in, port against the JAX synthesizer,
at ``tests/test_torch_inference.py``'s waveform tolerance (1e-3 of the peak).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer
from matcha_tpu.models import flow_matching as jfm
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch.inference import MatchaSynthesizer
from matcha_tpu_torch.models import flow_matching as tfm
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.vocoder.vocos import VocosConfig
from matcha_tpu_torch.weights import params_from_jax, vocos_params_from_jax

SEEDS = (0, 42, 1234)
# the JAX row at seed 42, (2048, 100): its first four values and its float64
# sum; chip_smoke.py's seeded_noise phase holds the port's row against them
JAX_ROW42_HEAD = (-0.02830461598932743, 0.4671318531036377, 0.2957029640674591, 0.15354591608047485)
JAX_ROW42_SUM = -605.9497001221935
SHAPES = ((2048, 100), (7, 80))
WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
BUCKETS = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_threefry_bits_equal_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    np.testing.assert_array_equal(tfm.threefry_bits(seed, shape), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_noise_row_matches_jax(seed, shape):
    want = np.asarray(jfm.seeded_synthesis_noise(1, *shape, seed=seed))[0]
    got = tfm.seeded_synthesis_noise(*shape, seed=seed).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pinned_seed42_row():
    """The constants chip_smoke.py prints beside the port's row: JAX's own
    (exact), and the port's within 4 ulp each and 1e-3 on the sum of
    204,800 values (6.4e-6 on the CPU)."""
    want = np.asarray(jfm.seeded_synthesis_noise(1, 2048, 100, seed=42))[0]
    assert tuple(want[0, :4].tolist()) == JAX_ROW42_HEAD
    assert float(want.astype(np.float64).sum()) == JAX_ROW42_SUM
    got = tfm.seeded_synthesis_noise(2048, 100, 42).numpy()
    np.testing.assert_allclose(got[0, :4], JAX_ROW42_HEAD, rtol=4 * np.finfo(np.float32).eps)
    assert abs(float(got.astype(np.float64).sum()) - JAX_ROW42_SUM) <= 1e-3


def test_erf_inv_edges():
    x = np.asarray([-1.0, 0.0, 1.0, np.nextafter(np.float32(-1), np.float32(0))], np.float32)
    got = tfm.erf_inv_f32(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isneginf(got[0]) and got[1] == 0.0 and np.isposinf(got[2])
    np.testing.assert_allclose(got[3], want[3], rtol=4 * np.finfo(np.float32).eps)


def test_decode_without_noise_uses_the_seeded_row():
    """``cfm_synthesise(noise=None)`` starts every row from the seed's row."""
    mu = torch.zeros((2, 5, 3))
    mask = torch.ones((2, 5))
    out = tfm.cfm_synthesise(lambda x, m, mu, t: torch.zeros_like(x), mu, mask, 2, noise_seed=7)
    row = tfm.seeded_synthesis_noise(5, 3, 7)
    assert torch.equal(out[0], row) and torch.equal(out[1], row)


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    vparams = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**WIDTHS)))
    ref = JaxSynthesizer(jax_tiny_config(), params, vparams, JaxVocosConfig(**WIDTHS), **BUCKETS)
    port = MatchaSynthesizer(
        tiny_config(), params_from_jax(params, tiny_config()),
        vocos_params_from_jax(vparams, VocosConfig(**WIDTHS)), VocosConfig(**WIDTHS),
        device="cpu", **BUCKETS,
    )
    return ref, port


@pytest.mark.parametrize("n", [12, 27])
def test_fused_audio_matches_jax_without_injected_noise(pair, n):
    ref, port = pair
    ids = [int(i) for i in np.random.default_rng(n).integers(0, 600, n)]
    r = ref.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    p = port.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    assert p.wav.shape == r.wav.shape and len(p.wav) > 0
    np.testing.assert_allclose(p.wav, r.wav, atol=1e-3 * np.abs(r.wav).max())
