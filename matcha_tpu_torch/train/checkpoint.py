"""Training checkpoints in the flat format the port's reader loads, and
checkpoint surgery.

``save_tree`` writes a directory with ``config.json`` (the full
MatchaConfig) and ``state.npz``: one array per leaf of a nested numpy tree,
keyed by its jax key path as ``matcha_tpu/train/checkpoint.py`` writes it
without orbax; ``matcha_tpu_torch.checkpoint.load_checkpoint`` reads it
back.  ``save_checkpoint`` writes a training state that way.  The
parameters are in the flax layout (``weights.params_to_jax``), so
``load_synthesizer`` serves a checkpoint the port trained and the JAX
package's models take its ``params`` tree.  Adam's moments sit under
``['opt_state']['mu'|'nu']`` (and ``acc_grads`` when gradients
accumulate) in the same layout, the optimizer's counters under
``['opt_state'][...]``, and ``['step']``, ``['epoch']`` at the top;
``train_state_from_tree`` turns a loaded tree back into a training state.

The surgery functions are the JAX package's (``matcha_tpu/train/
checkpoint.py:80-198``) on these trees: stripping for release, uniform
averaging, speaker-table growth with the Adam moment rows, appending one
speaker, and copying a speaker's rows between checkpoints.  They return new
trees and never write into their inputs.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.train.optim import OptState
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, params_to_jax, unflatten_tree

SPEAKER_TABLES = ("speaker_embeddings_enc", "speaker_embeddings_dur")


def _keystr(path: str) -> str:
    return "".join(f"['{p}']" for p in path.split("/"))


def save_tree(path: str | Path, tree: Mapping, cfg: MatchaConfig) -> None:
    """A nested tree of arrays + its config → a flat checkpoint directory."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    flat = flatten_tree(tree)
    np.savez(path / "state.npz", **{_keystr(k): np.asarray(v) for k, v in flat.items()})
    (path / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))


def save_checkpoint(path: str | Path, params, opt_state: OptState, step: int, epoch: int,
                    cfg: MatchaConfig) -> None:
    tree = {
        "params": params_to_jax(params, cfg),
        "opt_state": {
            "mu": params_to_jax(opt_state.mu, cfg),
            "nu": params_to_jax(opt_state.nu, cfg),
            "count": np.asarray(int(opt_state.count), np.int32),
            "notfinite_count": np.asarray(int(opt_state.notfinite_count), np.int32),
            "mini_step": np.asarray(opt_state.mini_step, np.int32),
        },
        "step": np.asarray(step, np.int64),
        "epoch": np.asarray(epoch, np.int64),
    }
    if opt_state.acc_grads is not None:
        tree["opt_state"]["acc_grads"] = params_to_jax(opt_state.acc_grads, cfg)
    save_tree(path, tree, cfg)


def train_state_from_tree(tree: Mapping, cfg: MatchaConfig, device, with_optimizer: bool = True):
    """A loaded checkpoint tree → (params, OptState or None, step, epoch).

    Tensors land on ``device``; params require grad.
    """
    def to_state(subtree):
        return {n: t.to(device) for n, t in params_from_jax(subtree, cfg).items()}

    params = {n: t.requires_grad_(True) for n, t in to_state(tree["params"]).items()}
    opt_state = None
    if with_optimizer:
        o = tree["opt_state"]
        opt_state = OptState(
            mu=to_state(o["mu"]),
            nu=to_state(o["nu"]),
            count=torch.tensor(int(o["count"]), dtype=torch.int32, device=device),
            notfinite_count=torch.tensor(int(o["notfinite_count"]), dtype=torch.int32, device=device),
            mini_step=int(o["mini_step"]),
            acc_grads=to_state(o["acc_grads"]) if "acc_grads" in o else None,
        )
    # a released checkpoint (strip_for_release) has no epoch
    return params, opt_state, int(tree.get("step", 0)), int(tree.get("epoch", 0))


# ---------------------------------------------------------------------------
# surgery
# ---------------------------------------------------------------------------

def _copy_containers(tree):
    """New dicts all the way down; the leaves are shared."""
    if isinstance(tree, Mapping):
        return {k: _copy_containers(v) for k, v in tree.items()}
    return tree


def strip_for_release(tree: Mapping) -> dict:
    """Drop optimizer state, keep params only (smaller serving artifact)."""
    return {"params": tree["params"], "step": tree.get("step", 0)}


def average_checkpoints(trees: list[Mapping]) -> dict:
    """Uniform parameter average of N checkpoints (params subtree only):
    a float64 mean per leaf, cast back to the last tree's leaf dtype; every
    other entry is the last tree's."""
    n = float(len(trees))
    flats = [flatten_tree(t["params"]) for t in trees]
    ref = flats[-1]
    avg = {}
    for path, leaf in ref.items():
        mean = sum(np.asarray(f[path], dtype=np.float64) for f in flats) / n
        avg[path] = mean.astype(np.asarray(leaf).dtype)
    out = dict(trees[-1])
    out["params"] = unflatten_tree(avg)
    return out


def _grow_rows(arr, extra: int) -> np.ndarray:
    arr = np.asarray(arr)
    return np.concatenate([arr, np.zeros((extra,) + arr.shape[1:], arr.dtype)], axis=0)


def _grow_tables(node, extra: int) -> None:
    """Zero-extend every ``speaker_embeddings_*/embedding`` leaf under
    ``node`` (params, and Adam's mu / nu / acc_grads), in place."""
    for k, v in node.items():
        if not isinstance(v, dict):
            continue
        if k in SPEAKER_TABLES and "embedding" in v:
            v["embedding"] = _grow_rows(v["embedding"], extra)
        else:
            _grow_tables(v, extra)


def expand_speaker_tables(tree: Mapping, cfg: MatchaConfig,
                          new_n_spks: int) -> tuple[dict, MatchaConfig]:
    """Grow both speaker-embedding tables, and their Adam moment rows, to
    ``new_n_spks`` rows with zeros, so training resumes with added speakers.
    Scalar counters stay as they are.  No-op when ``new_n_spks`` is not
    larger."""
    if new_n_spks <= cfg.n_spks:
        return tree, cfg
    tree = _copy_containers(tree)
    _grow_tables(tree, new_n_spks - cfg.n_spks)
    return tree, dataclasses.replace(cfg, n_spks=new_n_spks)


def add_speaker_rows(tree: Mapping, cfg: MatchaConfig, enc_row: np.ndarray,
                     dur_row: np.ndarray) -> tuple[dict, MatchaConfig]:
    """Append one concrete speaker (e.g. StyleEncoder-predicted embeddings)."""
    tree, cfg2 = expand_speaker_tables(tree, cfg, cfg.n_spks + 1)
    for name, row in zip(SPEAKER_TABLES, (enc_row, dur_row)):
        tree["params"][name]["embedding"][-1] = np.asarray(row)
    return tree, cfg2


def transplant_speaker(dst_tree: Mapping, src_tree: Mapping, dst_id: int, src_id: int) -> dict:
    """Copy one speaker's embedding rows from ``src_tree`` into a copy of
    ``dst_tree``."""
    out = _copy_containers(dst_tree)
    for name in SPEAKER_TABLES:
        dst = np.array(out["params"][name]["embedding"])
        dst[dst_id] = np.asarray(src_tree["params"][name]["embedding"])[src_id]
        out["params"][name]["embedding"] = dst
    return out
