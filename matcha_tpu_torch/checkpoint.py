"""Checkpoint directories of the JAX package → a ready synthesizer.

Reads the flat format that ``matcha_tpu/train/checkpoint.py::save_checkpoint``
writes without orbax (lines 46-52): ``config.json`` (the full MatchaConfig)
plus ``state.npz``, one array per leaf keyed by its
``jax.tree_util.keystr`` path.  Dict keys read ``['params']['encoder']``;
the optax state of a trainer checkpoint adds attribute steps (``.mu``, a
NamedTuple field) and index steps (``[1]``, a tuple element), as in
``['opt_state'].inner_state[1][0].mu['encoder']…``.  The loaded tree keeps
each step as a key of a nested dict: a ``str`` for a dict key, an
``Attr`` (a ``str`` that remembers it was a field) for an attribute, an
``int`` for an index, so ``keystr`` writes the same paths back.  numpy
alone reads it.  Orbax directories (``state/``) are zstd-compressed OCDBT,
which the standard library cannot read: ``tools/convert_orbax_checkpoint.py``
turns one into this format.

The Vocos weights are the parameter pickle that ``tools/convert_vocos.py``
writes (a nested dict of numpy arrays); its widths are read off the shapes,
as ``matcha_tpu/cli.py::infer_vocos_config`` does.  Unpickle only files that
tool wrote: unpickling runs code.
"""

from __future__ import annotations

import json
import pickle
import re
from collections.abc import Mapping
from pathlib import Path

import numpy as np

from matcha_tpu_torch.models.config import DiTConfig, MatchaConfig, model_config_from_dict
from matcha_tpu_torch.vocoder.vocos import VocosConfig
from matcha_tpu_torch.weights import params_from_jax, vocos_params_from_jax

_STEP = re.compile(r"\['([^'\\]*)'\]|\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


class Attr(str):
    """A key path step that names a NamedTuple field (``.mu``); equal to and
    hashed as the plain string, so ``tree["mu"]`` finds it."""

    __slots__ = ()


def parse_keystr(key: str) -> list:
    """``jax.tree_util.keystr`` output → its steps (``str`` / ``Attr`` /
    ``int``); raises on anything else."""
    steps, pos = [], 0
    while pos < len(key):
        m = _STEP.match(key, pos)
        if m is None:
            raise ValueError(f"unexpected key {key!r}")
        name, attr, index = m.groups()
        steps.append(name if name is not None else Attr(attr) if attr is not None else int(index))
        pos = m.end()
    if not steps:
        raise ValueError(f"unexpected key {key!r}")
    return steps


def keystr(steps) -> str:
    """The inverse of ``parse_keystr``."""
    return "".join(f".{s}" if isinstance(s, Attr) else f"[{s}]" if isinstance(s, int) else f"['{s}']"
                   for s in steps)


def flatten_keystr(tree: Mapping, prefix: tuple = ()) -> dict[str, object]:
    """Nested tree → {keystr path: leaf}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten_keystr(v, prefix + (k,)))
        else:
            flat[keystr(prefix + (k,))] = v
    return flat


def load_checkpoint(path: str | Path) -> tuple[dict, MatchaConfig | DiTConfig]:
    """Checkpoint directory → (nested numpy tree, config of the model it holds)."""
    path = Path(path)
    cfg = model_config_from_dict(json.loads((path / "config.json").read_text()))
    npz = path / "state.npz"
    if not npz.exists():
        if (path / "state").exists():
            raise NotImplementedError(
                f"{path} holds an orbax checkpoint, which the port cannot read; convert it with "
                f"`python tools/convert_orbax_checkpoint.py --to-flat {path}` (needs JAX and orbax)"
            )
        raise FileNotFoundError(f"No checkpoint state under {path}")
    tree: dict = {}
    with np.load(npz) as data:
        for key in data.files:
            *parents, leaf = parse_keystr(key)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
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
    if isinstance(cfg, DiTConfig):
        raise ValueError(f"{checkpoint_path} holds F5-TTS's DiT, which the port trains but does not serve")
    params = params_from_jax(tree["params"], cfg)
    vocos_params, vocos_cfg = None, VocosConfig()
    if vocoder_path:
        vocos_params, vocos_cfg = load_vocos(vocoder_path)
    return MatchaSynthesizer(cfg, params, vocos_params, vocos_cfg, **synth_kwargs)
