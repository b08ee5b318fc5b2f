"""Weight bridge: flax parameter trees → the port's state_dicts.

Every flax leaf is consumed exactly once and every torch parameter is
filled, at tiny_config and at production widths (shapes only there), and
the JAX package's own converters map the bridged state_dict back to the
original tree exactly (the bridge is their inverse).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matcha_tpu.models.config import MatchaConfig as JaxMatchaConfig
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch.models.config import MatchaConfig, tiny_config
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.vocoder.vocos import Vocos, VocosConfig
from matcha_tpu_torch.weights import (
    flatten_tree,
    matcha_param_table,
    params_from_jax,
    params_to_jax,
    vocos_params_from_jax,
)
from tools.convert_matcha_ckpt import convert_state_dict
from tools.convert_vocos import convert_vocos_state_dict

TINY_V = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=2)


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))


def _assert_fills_module(state, module):
    expected = module.state_dict()
    assert set(state) == set(expected)
    for k, v in state.items():
        assert tuple(v.shape) == tuple(expected[k].shape), k


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def test_tiny_fills_every_parameter(tiny_params):
    cfg = tiny_config()
    state = params_from_jax(tiny_params, cfg)
    _assert_fills_module(state, MatchaTTS(cfg))
    flax_paths = [row[1] for row in matcha_param_table(cfg)]
    assert len(flax_paths) == len(set(flax_paths)) == len(flatten_tree(tiny_params))
    MatchaTTS(cfg).load_state_dict(state)  # strict


def test_tiny_round_trips_through_the_reference_converter(tiny_params):
    cfg = tiny_config()
    state = {k: v.numpy() for k, v in params_from_jax(tiny_params, cfg).items()}
    back = convert_state_dict(
        state,
        n_layers_enc=cfg.encoder.n_layers,
        prenet_layers=cfg.encoder.prenet_layers,
        dp_layers=cfg.duration_predictor.n_layers,
        channels=cfg.decoder.channels,
        n_blocks=cfg.decoder.n_blocks,
        num_mid_blocks=cfg.decoder.num_mid_blocks,
        strict=True,
    )
    _assert_trees_equal(back, tiny_params)


def test_params_to_jax_inverts_the_bridge(tiny_params):
    cfg = tiny_config()
    _assert_trees_equal(params_to_jax(params_from_jax(tiny_params, cfg), cfg), tiny_params)
    state = params_from_jax(tiny_params, cfg)
    state.pop("encoder.emb.weight")
    with pytest.raises(KeyError):
        params_to_jax(state, cfg)


def test_missing_or_extra_leaf_raises(tiny_params):
    cfg = tiny_config()
    extra = dict(tiny_params, stray={"kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="not mapped"):
        params_from_jax(extra, cfg)
    missing = dict(tiny_params)
    missing.pop("speaker_embeddings_dur")
    with pytest.raises(KeyError):
        params_from_jax(missing, cfg)


def test_production_shapes():
    shapes = jax.eval_shape(lambda k: init_params(JaxMatchaConfig(), k), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    _assert_fills_module(params_from_jax(zeros, MatchaConfig()), MatchaTTS(MatchaConfig()))


def test_vocos_tiny_round_trip():
    vcfg = VocosConfig(**TINY_V)
    tree = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**TINY_V)))
    state = vocos_params_from_jax(tree, vcfg)
    _assert_fills_module(state, Vocos(vcfg))
    back = convert_vocos_state_dict({k: v.numpy() for k, v in state.items()})
    _assert_trees_equal(back, tree)


def test_vocos_production_shapes():
    shapes = jax.eval_shape(lambda k: init_vocos_params(k, JaxVocosConfig()), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    _assert_fills_module(vocos_params_from_jax(zeros, VocosConfig()), Vocos(VocosConfig()))


def test_configs_are_field_for_field_copies():
    assert MatchaConfig().to_dict() == JaxMatchaConfig().to_dict()
    assert tiny_config().to_dict() == jax_tiny_config().to_dict()
    assert dataclasses.asdict(VocosConfig()) == dataclasses.asdict(JaxVocosConfig())
