"""Checkpoint directories of the JAX package → a ready synthesizer.

Reads the flat format that ``matcha_tpu/train/checkpoint.py::save_checkpoint``
writes without orbax (lines 46-52): ``config.json`` (the full MatchaConfig)
plus ``state.npz``, one array per leaf keyed by its jax key path
(``['params']['encoder']['emb']['embedding']``).  numpy alone reads it.  Orbax
directories (``state/``) need orbax and are not read yet.

The Vocos weights are the parameter pickle that ``tools/convert_vocos.py``
writes (a nested dict of numpy arrays); its widths are read off the shapes,
as ``matcha_tpu/cli.py::infer_vocos_config`` does.  Unpickle only files that
tool wrote: unpickling runs code.
"""

from __future__ import annotations

import json
import pickle
import re
from pathlib import Path

import numpy as np

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.vocoder.vocos import VocosConfig
from matcha_tpu_torch.weights import params_from_jax, vocos_params_from_jax

_KEY = re.compile(r"\['([^']*)'\]")


def load_checkpoint(path: str | Path) -> tuple[dict, MatchaConfig]:
    """Checkpoint directory → (nested numpy tree, config)."""
    path = Path(path)
    cfg = MatchaConfig.from_dict(json.loads((path / "config.json").read_text()))
    npz = path / "state.npz"
    if not npz.exists():
        if (path / "state").exists():
            raise NotImplementedError(
                f"{path} holds an orbax checkpoint; the port reads the flat state.npz format only"
            )
        raise FileNotFoundError(f"No checkpoint state under {path}")
    tree: dict = {}
    with np.load(npz) as data:
        for key in data.files:
            parts = _KEY.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"unexpected key {key!r} in {npz}")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree, cfg


def infer_vocos_config(params) -> VocosConfig:
    """VocosConfig from a converted param tree's shapes: embed kernel
    (7, input_channels, dim), pwconv1 kernel (dim, intermediate), head out
    kernel (dim, n_fft + 2), convnext{i} count = num_layers."""
    bb = params["backbone"]
    k_embed = bb["embed"]["kernel"].shape
    k_pw1 = bb["convnext0"]["pwconv1"]["kernel"].shape
    return VocosConfig(
        input_channels=int(k_embed[1]),
        dim=int(k_embed[2]),
        intermediate_dim=int(k_pw1[1]),
        num_layers=sum(1 for k in bb if k.startswith("convnext")),
        n_fft=int(params["head"]["out"]["kernel"].shape[-1] - 2),
    )


def load_vocos(path: str | Path):
    """Vocos param pickle → (port state_dict, VocosConfig)."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    vcfg = infer_vocos_config(tree)
    return vocos_params_from_jax(tree, vcfg), vcfg


def load_synthesizer(checkpoint_path: str, vocoder_path: str | None = None,
                     **synth_kwargs):
    """Checkpoint dir (+ optional Vocos pickle) → MatchaSynthesizer.

    ``synth_kwargs`` (text_buckets, mel_fine_buckets, device) pass through.
    """
    from matcha_tpu_torch.inference import MatchaSynthesizer

    tree, cfg = load_checkpoint(checkpoint_path)
    params = params_from_jax(tree["params"], cfg)
    vocos_params, vocos_cfg = None, VocosConfig()
    if vocoder_path:
        vocos_params, vocos_cfg = load_vocos(vocoder_path)
    return MatchaSynthesizer(cfg, params, vocos_params, vocos_cfg, **synth_kwargs)
