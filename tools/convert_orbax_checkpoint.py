"""Convert a JAX trainer checkpoint between orbax and the flat format.

Usage:
    python tools/convert_orbax_checkpoint.py --to-flat  <ckpt> [--out DIR]
    python tools/convert_orbax_checkpoint.py --to-orbax <ckpt> [--out DIR]

A checkpoint directory holds ``config.json`` and its state.  The JAX
trainer writes the state with orbax (``state/``, zstd-compressed OCDBT)
whenever orbax imports (``matcha_tpu/train/checkpoint.py:42-45``); the
PyTorch port reads and writes the flat format (``state.npz``, one array per
leaf keyed by its ``jax.tree_util.keystr`` path), which needs numpy alone.

``--to-flat`` restores ``<ckpt>/state`` with a template from
``matcha_tpu.train.step.init_train_state`` for the checkpoint's config, as
the JAX trainer resumes (``matcha_tpu/train/trainer.py:255-262``): the
template keeps optax's NamedTuples, so the keys are the trainer's own
(``['opt_state'].inner_state[1][0].mu…``).  ``--to-orbax`` fills the same
template from ``state.npz`` and saves it with orbax, so the JAX trainer
resumes a checkpoint the port wrote.  The optimizer chain's shape (gradient
accumulation, the finite check, a trainable mask) is read off the
checkpoint's keys; every leaf must match the template's shape, and none may
be left over.  ``--out`` defaults to ``<ckpt>`` itself.

Needs JAX, orbax and ``matcha_tpu``.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

from matcha_tpu.models.config import MatchaConfig  # noqa: E402
from matcha_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from matcha_tpu.train.optim import OptimizerConfig, build_optimizer  # noqa: E402
from matcha_tpu.train.step import init_train_state  # noqa: E402

_MASKED_ADAM = re.compile(r"\[0\]\[1\]\[0\]")


def chain_shape(keys) -> dict:
    """The optimizer chain's wrappers, from a checkpoint's leaf paths (flat
    ``keystr`` keys or an untargeted orbax restore's, where NamedTuples
    came back as dicts and tuples as lists)."""
    opt = [k for k in keys if k.startswith("['opt_state']")]
    return {
        "top": sorted({re.match(r"\['([^']*)'\]", k).group(1) for k in keys}),
        "accumulate": any("inner_opt_state" in k for k in opt),
        "skip_nonfinite": any("notfinite_count" in k for k in opt),
        "masked": any(_MASKED_ADAM.search(k) for k in opt),
    }


def template(cfg: MatchaConfig, shape: dict) -> dict:
    """A trainer state of the checkpoint's top-level entries and optimizer
    chain: ``init_train_state``'s structure, shapes and dtypes (traced,
    not run), as zeros."""
    opt_cfg = OptimizerConfig(accumulate_grad_batches=2 if shape["accumulate"] else 1,
                              skip_nonfinite_updates=shape["skip_nonfinite"])

    def abstract_state(mask=None):
        tx = build_optimizer(opt_cfg, trainable_mask=mask)
        return jax.eval_shape(lambda: init_train_state(cfg, tx, jax.random.PRNGKey(0)))

    state = abstract_state()
    if shape["masked"]:
        state = abstract_state(jax.tree.map(lambda _: True, state.params))
    full = {"params": state.params, "opt_state": state.opt_state, "step": 0, "epoch": 0}
    missing = set(shape["top"]) - set(full)
    if missing:
        raise ValueError(f"checkpoint entries {sorted(missing)} have no place in a trainer state")
    return {k: jax.tree.map(lambda a: np.zeros(np.shape(a), a.dtype) if hasattr(a, "dtype") else np.asarray(a),
                            full[k]) for k in shape["top"]}


def _flat_keys(tree) -> list[str]:
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _config(src: Path) -> MatchaConfig:
    return MatchaConfig.from_dict(json.loads((src / "config.json").read_text()))


def _copy_config(src: Path, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    if (out / "config.json").resolve() != (src / "config.json").resolve():
        shutil.copyfile(src / "config.json", out / "config.json")


def to_flat(src: Path, out: Path) -> Path:
    """``<src>/state`` (orbax) → ``<out>/state.npz`` + ``config.json``."""
    cfg = _config(src)
    raw, _ = jax_checkpoint.load_checkpoint(src)  # untargeted: the structure only
    target = template(cfg, chain_shape(_flat_keys(raw)))
    tree, _ = jax_checkpoint.load_checkpoint(src, target=target)
    _copy_config(src, out)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(out / "state.npz", **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    return out


def to_orbax(src: Path, out: Path) -> Path:
    """``<src>/state.npz`` → ``<out>/state`` (orbax) + ``config.json``."""
    if not jax_checkpoint._HAS_ORBAX:
        raise RuntimeError("orbax is not importable: it is needed to write an orbax checkpoint")
    cfg = _config(src)
    with np.load(src / "state.npz") as data:
        arrays = {k: data[k] for k in data.files}
    target = template(cfg, chain_shape(arrays))
    paths, treedef = jax.tree_util.tree_flatten_with_path(target)
    leaves = []
    for path, ref in paths:
        key = jax.tree_util.keystr(path)
        if key not in arrays:
            raise KeyError(f"{src / 'state.npz'} has no {key}")
        value = arrays.pop(key)
        if value.shape != np.shape(ref):
            raise ValueError(f"{key}: shape {value.shape}, the trainer's is {np.shape(ref)}")
        leaves.append(value.astype(np.asarray(ref).dtype))
    if arrays:
        raise ValueError(f"keys with no place in the trainer state: {sorted(arrays)[:5]}")
    out.mkdir(parents=True, exist_ok=True)
    jax_checkpoint.save_checkpoint(out, jax.tree_util.tree_unflatten(treedef, leaves), cfg)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    way = parser.add_mutually_exclusive_group(required=True)
    way.add_argument("--to-flat", metavar="CKPT", help="orbax state/ → state.npz")
    way.add_argument("--to-orbax", metavar="CKPT", help="state.npz → orbax state/")
    parser.add_argument("--out", help="output checkpoint directory (default: the input)")
    args = parser.parse_args(argv)
    src = Path(args.to_flat or args.to_orbax).absolute()
    out = Path(args.out).absolute() if args.out else src
    done = to_flat(src, out) if args.to_flat else to_orbax(src, out)
    print(f"wrote {done}")


if __name__ == "__main__":
    main()
