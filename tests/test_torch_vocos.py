"""Port parity: the Vocos waveform vs the JAX Vocos, bridged weights.

fp32 on both sides; the tanh-approximate GELU is what flax's nn.gelu
computes.  Tolerance 1e-4 relative to the waveform's peak: the ISTFT sums
exp() magnitudes over 513 bins, and fp32 rounding there scales with them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.vocoder.vocos import Vocos as JaxVocos
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch.vocoder.vocos import Vocos, VocosConfig, hann_window
from matcha_tpu.audio.mel import hann_window as jax_hann_window
from matcha_tpu_torch.weights import vocos_params_from_jax

WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=2)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxVocosConfig(**WIDTHS)
    tree = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), jcfg))
    # layer scale 1e-6 would hide the ConvNeXt blocks: make them count
    for i in range(WIDTHS["num_layers"]):
        tree["backbone"][f"convnext{i}"]["gamma"] = np.full((32,), 0.5, np.float32)
    port = Vocos(VocosConfig(**WIDTHS))
    port.load_state_dict(vocos_params_from_jax(tree, VocosConfig(**WIDTHS)))
    return jcfg, tree, port.eval()


@pytest.mark.parametrize("frames", [5, 20])
def test_waveform(models, frames):
    jcfg, tree, port = models
    mel = (np.random.default_rng(frames).standard_normal((2, frames, 8)) * 2.0 - 4.0).astype(np.float32)
    ref = np.asarray(JaxVocos(jcfg).apply({"params": tree}, jnp.asarray(mel)))
    with torch.no_grad():
        ours = port(torch.from_numpy(mel)).numpy()
    assert ours.shape == ref.shape == (2, (frames - 1) * 256)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_gelu_is_tanh_approximation(models):
    # exact GELU differs from flax's default by ~1e-3 near |x| ~ 2
    x = torch.linspace(-4, 4, 101)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(torch.nn.functional.gelu(x, approximate="tanh").numpy(), ref, atol=1e-6)
    assert np.abs(torch.nn.functional.gelu(x).numpy() - ref).max() > 1e-4


def test_hann_window_copy():
    np.testing.assert_array_equal(hann_window(1024), jax_hann_window(1024))
