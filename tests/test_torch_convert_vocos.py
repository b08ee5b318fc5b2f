"""The port's Vocos converter against ``tools/convert_vocos.py``.

``matcha_tpu_torch.convert_vocos`` runs with no JAX; here it is held
against the JAX tool in every layout of ``tests/test_vocos_converter.py``
(plain, explicit depth, HF buffers beside the weights, each wrapper
prefix, both weight-norm styles): the flax trees bit for bit
(``np.array_equal``, same dtype).  The same inputs raise the same errors
with the same messages.  The widths are read off the shapes.  The port's
Vocos on its CLI's pickle equals the JAX Vocos on the JAX tool's tree
within 1e-4 of the waveform's peak, the tolerance of
``tests/test_torch_vocos.py`` (fp32 rounding through the ISTFT's exp()).
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import convert_vocos as jtool  # noqa: E402
from test_vocos_converter import synth_vocos_state_dict  # noqa: E402

from matcha_tpu.vocoder.vocos import Vocos as JaxVocos  # noqa: E402
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig  # noqa: E402
from matcha_tpu_torch import convert_vocos as port  # noqa: E402
from matcha_tpu_torch.checkpoint import load_vocos  # noqa: E402
from matcha_tpu_torch.vocoder.vocos import Vocos, VocosConfig  # noqa: E402
from matcha_tpu_torch.weights import flatten_tree  # noqa: E402

WIDTHS = dict(dim=32, intermediate_dim=64, num_layers=2)


def plain() -> dict:
    return synth_vocos_state_dict(JaxVocosConfig(**WIDTHS))


def with_buffers():
    sd = plain()
    sd["feature_extractor.mel_spec.spectrogram.window"] = np.hanning(1024)
    sd["feature_extractor.mel_spec.mel_scale.fb"] = np.zeros((513, 100))
    sd["head.istft.window"] = np.hanning(1024)
    return sd


def prefixed(prefix):
    return lambda: {prefix + k: v for k, v in plain().items()}


def new_style_weight_norm():
    sd = plain()
    for mod in ("backbone.convnext.0.dwconv", "backbone.embed"):
        w = sd.pop(f"{mod}.weight")
        norm = np.sqrt(np.sum(w * w, axis=tuple(range(1, w.ndim)), keepdims=True))
        sd[f"{mod}.parametrizations.weight.original0"] = norm.reshape(-1)
        sd[f"{mod}.parametrizations.weight.original1"] = w
    return sd


def old_style_weight_norm():
    sd = plain()
    w = sd.pop("backbone.convnext.1.pwconv1.weight")
    sd["backbone.convnext.1.pwconv1.weight_g"] = np.sqrt(np.sum(w * w, axis=1, keepdims=True))
    sd["backbone.convnext.1.pwconv1.weight_v"] = w
    return sd


LAYOUTS = {"plain": plain, "buffers": with_buffers, "model.": prefixed("model."),
           "module.": prefixed("module."), "_orig_mod.": prefixed("_orig_mod."),
           "weight_norm_parametrizations": new_style_weight_norm, "weight_norm_g_v": old_style_weight_norm}


def assert_trees_bit_equal(got: dict, want: dict) -> None:
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tree_equals_jax_tool_bit_for_bit(layout):
    sd = LAYOUTS[layout]()
    assert_trees_bit_equal(port.convert_vocos_state_dict(sd), jtool.convert_vocos_state_dict(sd))


def test_explicit_depth_equals_inferred():
    assert_trees_bit_equal(port.convert_vocos_state_dict(plain(), num_layers=2),
                           jtool.convert_vocos_state_dict(plain(), num_layers=2))


def test_widths_read_off_the_shapes():
    for widths in (WIDTHS, dict(input_channels=12, dim=24, intermediate_dim=40, num_layers=3, n_fft=64)):
        sd = synth_vocos_state_dict(JaxVocosConfig(**widths))
        state, cfg = port.vocos_state_dict(sd)
        assert cfg == VocosConfig(**widths)
        Vocos(cfg).load_state_dict(state, strict=True)


def missing_key():
    sd = plain()
    del sd["backbone.convnext.1.gamma"]
    return sd


def unexpected_key():
    sd = plain()
    sd["backbone.mystery_adapter.weight"] = np.zeros((4, 4))
    return sd


def orphan_parametrization():
    sd = plain()
    w = sd.pop("backbone.embed.weight")
    sd["backbone.embed.parametrizations.weight.original0"] = np.ones((w.shape[0],))
    return sd


def not_vocos():
    return {"encoder.emb.weight": np.zeros((4, 4), np.float32)}


@pytest.mark.parametrize("make,exc,names", [
    (missing_key, KeyError, "backbone.convnext.1.gamma"),
    (unexpected_key, ValueError, "mystery_adapter"),
    (orphan_parametrization, KeyError, "original1"),
    (not_vocos, KeyError, "backbone.convnext"),
], ids=["missing", "unexpected", "orphan_parametrization", "not_vocos"])
def test_same_errors_as_the_jax_tool(make, exc, names):
    with pytest.raises(exc) as want:
        jtool.convert_vocos_state_dict(make())
    with pytest.raises(exc) as got:
        port.convert_vocos_state_dict(make())
    assert str(got.value) == str(want.value) and names in str(got.value)


def test_cli_pickle_runs_like_the_jax_vocos(tmp_path):
    sd = new_style_weight_norm()
    for i in range(WIDTHS["num_layers"]):  # layer scale 1e-6 would hide the blocks
        sd[f"backbone.convnext.{i}.gamma"] = np.full((WIDTHS["dim"],), 0.5, np.float32)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    port.main(["--input", str(tmp_path / "pytorch_model.bin"), "--output", str(tmp_path / "vocos.pkl")])
    jtree = jtool.convert_vocos_state_dict({k: np.asarray(v, np.float32) for k, v in sd.items()})
    with open(tmp_path / "vocos.pkl", "rb") as f:
        assert_trees_bit_equal(pickle.load(f), jtree)

    state, cfg = load_vocos(tmp_path / "vocos.pkl")
    model = Vocos(cfg)
    model.load_state_dict(state)
    mel = (np.random.default_rng(4).standard_normal((2, 20, cfg.input_channels)) * 2.0 - 4.0).astype(np.float32)
    ref = np.asarray(JaxVocos(JaxVocosConfig(**WIDTHS)).apply({"params": jtree}, jnp.asarray(mel)))
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(mel)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_verify_says_the_vocos_package_is_absent(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "vocos", None)  # import vocos raises ImportError
    with pytest.raises(SystemExit, match="`vocos` package"):
        port.main(["--verify", str(tmp_path / "vocos.pkl"), "--device", "cpu"])
