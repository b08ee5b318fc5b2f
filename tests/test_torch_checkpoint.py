"""The port's checkpoint reader against the JAX package's writer.

``matcha_tpu.train.checkpoint.save_checkpoint`` writes the flat
``config.json`` + ``state.npz`` format when orbax is absent; the test forces
that branch and reads the directory back with numpy alone through the port.
The Vocos pickle is the nested dict of numpy arrays that
``tools/convert_vocos.py`` writes.  Exact equality: nothing is recomputed.
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from matcha_tpu import cli as jax_cli
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.train import checkpoint as jax_checkpoint
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch import checkpoint as ckpt
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, vocos_params_from_jax

TINY_V = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=2)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    vparams = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**TINY_V)))
    root = tmp_path_factory.mktemp("ckpt")
    (root / "step_1").mkdir()  # the flat branch writes into an existing directory
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_checkpoint, "_HAS_ORBAX", False)
        jax_checkpoint.save_checkpoint(root / "step_1", {"params": params, "step": 1}, jax_tiny_config())
    with open(root / "vocos.pkl", "wb") as f:
        pickle.dump(vparams, f)
    return root, params, vparams


def test_flat_checkpoint_reads_back_exactly(saved):
    root, params, _ = saved
    tree, cfg = ckpt.load_checkpoint(root / "step_1")
    assert cfg.to_dict() == tiny_config().to_dict()
    assert int(tree["step"]) == 1
    got, want = flatten_tree(tree["params"]), flatten_tree(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_vocos_pickle_and_config_match_the_jax_reader(saved):
    root, _, vparams = saved
    state, vcfg = ckpt.load_vocos(root / "vocos.pkl")
    jax_vcfg = jax_cli.infer_vocos_config(vparams)
    assert vcfg.__dict__ == jax_vcfg.__dict__
    want = vocos_params_from_jax(vparams, vcfg)
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_load_synthesizer_fills_the_model(saved):
    root, params, _ = saved
    synth = ckpt.load_synthesizer(str(root / "step_1"), str(root / "vocos.pkl"), device="cpu",
                                  text_buckets=(16, 32), mel_fine_buckets=(64, 128))
    want = params_from_jax(params, tiny_config())
    got = synth.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert synth.vocos is not None and synth.vocos_cfg.dim == TINY_V["dim"]


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "state").mkdir()
    (tmp_path / "config.json").write_text(json.dumps(jax_tiny_config().to_dict()))
    with pytest.raises(NotImplementedError):
        ckpt.load_checkpoint(tmp_path)


def test_missing_state_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(jax_tiny_config().to_dict()))
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path)
