"""The port's Lightning-checkpoint converter against ``tools/convert_matcha_ckpt.py``.

``matcha_tpu_torch.convert_matcha_ckpt`` runs with no JAX; here it is held
against the JAX tool on the same inputs:

- ``config_from_hparams``: equal configs (``to_dict``) for hparams as
  dicts, namespaces, a mix of both, item-access-only objects (omegaconf
  style), at non-default and v20 widths, and empty hparams;
- the flax tree: bit for bit (``np.array_equal``, same dtype) on
  ``tests/test_converter_structure.py::synth_reference_state_dict`` with
  ``._orig_mod`` segments, at small and production widths;
- leftover tensors: the same warning, or the same ``ValueError`` with
  ``--strict``;
- the StyleEncoder tree: bit for bit;
- end to end: a Lightning ``.ckpt`` and an HF-layout Vocos file (one conv
  weight-normed) through both CLIs, served by ``load_synthesizer`` on the
  CPU against the JAX synthesizer on the JAX tools' trees: mel within 2e-3
  and waveform within 1e-3 of its peak, the fp32 tolerances of
  ``tests/test_torch_inference.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace as NS

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import convert_matcha_ckpt as jtool  # noqa: E402
import convert_vocos as jvtool  # noqa: E402
from test_converter_structure import synth_reference_state_dict  # noqa: E402

from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer  # noqa: E402
from matcha_tpu.models.config import MatchaConfig as JaxMatchaConfig  # noqa: E402
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig  # noqa: E402
from matcha_tpu_torch import convert_matcha_ckpt as port  # noqa: E402
from matcha_tpu_torch import convert_vocos as port_vocos  # noqa: E402
from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer  # noqa: E402
from matcha_tpu_torch.models.matcha import init_params  # noqa: E402
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params  # noqa: E402
from matcha_tpu_torch.weights import flatten_tree  # noqa: E402

SMALL = dict(
    n_spks=4, n_feats=8, spk_emb_dim=8,
    enc=dict(n_channels=16, filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, prenet_kernel_size=3),
    dp=dict(filter_channels=16, kernel_size=3, n_layers=2),
    dec=dict(channels=[32, 32], attention_head_dim=8, n_blocks=1, num_mid_blocks=1, num_heads=2),
)
V20 = dict(
    n_spks=16, n_feats=100, spk_emb_dim=96,
    enc=dict(n_channels=192, filter_channels=1152, n_heads=6, n_layers=4, kernel_size=5, prenet_kernel_size=3),
    dp=dict(filter_channels=96, kernel_size=5, n_layers=4),
    dec=dict(channels=[384, 384], attention_head_dim=64, n_blocks=2, num_mid_blocks=2, num_heads=6),
)
VOCOS_WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=2)
BUCKETS = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256))


class ItemOnly:
    """omegaconf-style node read by ``node[key]`` only (attribute access raises)."""

    def __init__(self, d):
        self._d = {k: ItemOnly(v) if isinstance(v, dict) else v for k, v in d.items()}

    def __getitem__(self, key):
        return self._d[key]


def lightning_hparams(spec, form: str):
    """The init-kwargs Lightning's save_hyperparameters persists, nested as
    ``form``: "dict", "namespace", "mixed" (namespaces for the encoder,
    dicts elsewhere) or "items" (item access only)."""
    encoder = {
        "encoder_params": dict(n_feats=spec["n_feats"], prenet=True, p_dropout=0.05, **spec["enc"]),
        "duration_predictor_params": dict(filter_channels_dp=spec["dp"]["filter_channels"],
                                          kernel_size=spec["dp"]["kernel_size"], p_dropout=0.05,
                                          n_layers=spec["dp"]["n_layers"]),
    }
    hp = {
        "n_spks": spec["n_spks"], "n_feats": spec["n_feats"], "spk_emb_dim": spec["spk_emb_dim"],
        "encoder": encoder,
        "decoder": dict(dropout=0.05, **spec["dec"]),
        "cfm": {"name": "CFM", "solver": "midpoint", "sigma_min": 1e-4, "use_mu_prior": True},
        "data_statistics": {"mel_mean": -5.5, "mel_std": 2.25},
        "optimizer": None, "scheduler": None,
        "prior_loss": True, "prior_loss_threshold": 0.15, "duration_loss_threshold": 0.3,
    }
    if form == "dict":
        return hp
    if form == "items":
        return ItemOnly(hp)

    def ns(d):
        return NS(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    if form == "namespace":
        return ns(hp)
    return dict(hp, encoder=ns(encoder))


@pytest.mark.parametrize("spec,form", [(SMALL, "dict"), (SMALL, "namespace"), (SMALL, "mixed"),
                                       (SMALL, "items"), (V20, "mixed"), (None, "empty")],
                         ids=["small-dict", "small-namespace", "small-mixed", "small-items", "v20-mixed", "empty"])
def test_config_from_hparams_matches_jax(spec, form):
    hp = {} if spec is None else lightning_hparams(spec, form)
    cfg = port.config_from_hparams(hp)
    assert cfg.to_dict() == jtool.config_from_hparams(hp).to_dict()
    if spec is None:
        assert cfg == port.MatchaConfig()
    else:
        assert cfg.decoder.channels == tuple(spec["dec"]["channels"])
        assert cfg.encoder.n_heads == spec["enc"]["n_heads"] and cfg.spk_emb_dim == spec["spk_emb_dim"]


def with_orig_mod(sd: dict) -> dict:
    """torch.compile's ``._orig_mod`` segment inside every decoder name."""
    e = "decoder.estimator."
    return {(e[:-1] + "._orig_mod." + k[len(e):] if k.startswith(e) else k): v for k, v in sd.items()}


def jax_tool_tree(sd: dict, cfg, strict: bool = False) -> dict:
    return jtool.convert_state_dict(
        {k: np.asarray(v) for k, v in sd.items()}, n_layers_enc=cfg.encoder.n_layers,
        prenet_layers=cfg.encoder.prenet_layers, dp_layers=cfg.duration_predictor.n_layers,
        channels=cfg.decoder.channels, n_blocks=cfg.decoder.n_blocks,
        num_mid_blocks=cfg.decoder.num_mid_blocks, strict=strict)


def assert_trees_bit_equal(got: dict, want: dict) -> None:
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("spec", [SMALL, None], ids=["small", "production"])
def test_tree_equals_jax_tool_bit_for_bit(spec):
    cfg = port.config_from_hparams({} if spec is None else lightning_hparams(spec, "dict"))
    sd = with_orig_mod(synth_reference_state_dict(JaxMatchaConfig.from_dict(cfg.to_dict())))
    got = port.convert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg, strict=True)
    assert_trees_bit_equal(got, jax_tool_tree(sd, cfg, strict=True))


@pytest.mark.parametrize("strict", [False, True], ids=["warn", "strict"])
def test_leftovers_as_the_jax_tool(strict, capsys):
    cfg = port.config_from_hparams(lightning_hparams(SMALL, "dict"))
    sd = synth_reference_state_dict(JaxMatchaConfig.from_dict(cfg.to_dict()))
    sd["mel_mean"], sd["mel_std"] = np.zeros(()), np.ones(())  # statistics buffers: never reported
    sd["encoder.mystery.weight"] = np.zeros((3,), np.float32)
    torch_sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    if strict:
        with pytest.raises(ValueError) as want:
            jax_tool_tree(sd, cfg, strict=True)
        with pytest.raises(ValueError) as got:
            port.convert_state_dict(torch_sd, cfg, strict=True)
        assert str(got.value) == str(want.value) and "encoder.mystery.weight" in str(got.value)
        return
    want_tree = jax_tool_tree(sd, cfg)
    want_out = capsys.readouterr().out
    assert_trees_bit_equal(port.convert_state_dict(torch_sd, cfg), want_tree)
    got_out = capsys.readouterr().out
    assert got_out == want_out and "1 unconverted tensors" in got_out


def test_missing_parameter_raises():
    cfg = port.config_from_hparams(lightning_hparams(SMALL, "dict"))
    sd = synth_reference_state_dict(JaxMatchaConfig.from_dict(cfg.to_dict()))
    del sd["encoder.proj_w.proj.bias"]
    with pytest.raises(KeyError):
        jax_tool_tree(sd, cfg)
    with pytest.raises(KeyError, match=r"encoder\.proj_w\.proj\.bias"):
        port.convert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)


def test_style_encoder_tree_equals_jax_tool():
    rng = np.random.default_rng(3)
    sd = {}
    for i in range(4):
        sd[f"style_encoder._orig_mod.convs.{i}.weight"] = rng.standard_normal((16, 8 if i == 0 else 16, 5))
        sd[f"style_encoder._orig_mod.convs.{i}.bias"] = rng.standard_normal((16,))
    for h, width in (("enc", 8), ("dur", 8)):
        sd[f"style_encoder._orig_mod.proj_{h}.weight"] = rng.standard_normal((width, 16))
        sd[f"style_encoder._orig_mod.proj_{h}.bias"] = rng.standard_normal((width,))
    sd["matcha.encoder.emb.weight"] = rng.standard_normal((4, 4))  # the frozen model beside it
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = jtool.convert_style_encoder_state_dict(sd)
    got = port.convert_style_encoder_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert_trees_bit_equal(got, want)


def hf_vocos_state_dict(cfg: VocosConfig, seed: int = 2) -> dict[str, torch.Tensor]:
    """A random HF-layout Vocos state dict, ``backbone.embed`` weight-normed
    (parametrizations style), layer scale 0.5 so the blocks count, and the
    ISTFT window buffer beside it."""
    sd = init_vocos_params(cfg, torch.Generator().manual_seed(seed))
    for i in range(cfg.num_layers):
        sd[f"backbone.convnext.{i}.gamma"] = torch.full((cfg.dim,), 0.5)
    w = sd.pop("backbone.embed.weight")
    sd["backbone.embed.parametrizations.weight.original0"] = w.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    sd["backbone.embed.parametrizations.weight.original1"] = w
    sd["head.istft.window"] = torch.hann_window(cfg.n_fft)
    return sd


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A Lightning .ckpt at SMALL widths (``._orig_mod`` names, namespace
    hparams, statistics buffers) and an HF Vocos file, through the port's
    CLIs and the JAX tools."""
    root = tmp_path_factory.mktemp("reference_ckpt")
    hp = lightning_hparams(SMALL, "namespace")
    cfg = port.config_from_hparams(hp)
    sd = with_orig_mod(init_params(cfg, torch.Generator().manual_seed(7)))
    sd["mel_mean"], sd["mel_std"] = torch.tensor(-5.5), torch.tensor(2.25)
    torch.save({"state_dict": sd, "hyper_parameters": hp, "epoch": 3, "global_step": 120}, root / "m.ckpt")
    port.main(["--input", str(root / "m.ckpt"), "--output", str(root / "converted"), "--strict"])

    vcfg = VocosConfig(**VOCOS_WIDTHS)
    vsd = hf_vocos_state_dict(vcfg)
    torch.save(vsd, root / "pytorch_model.bin")
    port_vocos.main(["--input", str(root / "pytorch_model.bin"), "--output", str(root / "vocos.pkl")])

    jcfg = jtool.config_from_hparams(hp)
    jtree = jax_tool_tree({k: v.numpy() for k, v in sd.items()}, jcfg, strict=True)
    jvtree = jvtool.convert_vocos_state_dict({k: v.numpy() for k, v in vsd.items()})
    return root, jcfg, jtree, jvtree


def test_cli_writes_the_jax_tools_trees(converted):
    root, jcfg, jtree, jvtree = converted
    tree, cfg = load_checkpoint(root / "converted")
    assert cfg.to_dict() == jcfg.to_dict()
    assert_trees_bit_equal(tree["params"], jtree)
    assert int(tree["step"]) == 0
    import pickle

    with open(root / "vocos.pkl", "rb") as f:
        assert_trees_bit_equal(pickle.load(f), jvtree)


@pytest.mark.parametrize("fused", [False, True], ids=["two-stage", "fused"])
def test_served_like_the_jax_synthesizer(converted, fused):
    root, jcfg, jtree, jvtree = converted
    ref = JaxSynthesizer(jcfg, jax.tree.map(np.asarray, jtree), jvtree, JaxVocosConfig(**VOCOS_WIDTHS), **BUCKETS)
    synth = load_synthesizer(str(root / "converted"), str(root / "vocos.pkl"), device="cpu", **BUCKETS)
    ids = [int(i) for i in np.random.default_rng(5).integers(0, 600, 17)]
    r = ref.synthesise_ids(ids, speaker=2, n_timesteps=2, fused=fused, debug=not fused)
    p = synth.synthesise_ids(ids, speaker=2, n_timesteps=2, fused=fused, debug=not fused)
    if not fused:
        assert p.mel.shape == r.mel.shape
        np.testing.assert_allclose(p.mel, r.mel, atol=2e-3)
    assert p.wav.shape == r.wav.shape and len(p.wav) > 0
    np.testing.assert_allclose(p.wav, r.wav, atol=1e-3 * np.abs(r.wav).max())
