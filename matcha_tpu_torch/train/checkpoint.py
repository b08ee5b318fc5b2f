"""Training checkpoints in the JAX trainer's flat format, and checkpoint
surgery.

``save_tree`` writes a directory with ``config.json`` (the full
MatchaConfig) and ``state.npz``: one array per leaf of a nested numpy tree,
keyed by its ``jax.tree_util.keystr`` path, as ``matcha_tpu/train/
checkpoint.py`` writes it without orbax; ``matcha_tpu_torch.checkpoint.
load_checkpoint`` reads it back.  ``save_checkpoint`` writes a training
state under the JAX trainer's own key paths, so a checkpoint of the port
is a checkpoint of the JAX trainer (through ``tools/
convert_orbax_checkpoint.py --to-orbax`` where that trainer reads orbax
only): the parameters in the flax layout (``weights.params_to_jax``), the
optimizer state where optax keeps it, ``['step']`` and ``['epoch']``.
A DiT's checkpoint (``DiTConfig``) and a CosyVoice 2 flow stage's
(``CosyFlowConfig``) have the same key paths, their parameters nested by
their torch names (``F5TTS.param_table``, ``CosyFlow.param_table``), and
``"arch": "f5tts_dit"`` or ``"cosyvoice2_flow"`` in their ``config.json``.

The optax chain of ``matcha_tpu/train/optim.py`` is
``MultiSteps(apply_if_finite(chain(chain(clip, adamw), masked(zero))))``,
each wrapper present only when configured (accumulation > 1, the finite
check on, a trainable mask set).  Its leaves, and their ``OptState`` fields:

  MultiSteps        .mini_step → mini_step      .gradient_step → gradient_step
                    .acc_grads[...] → acc_grads .inner_opt_state → (below)
  apply_if_finite   .notfinite_count → notfinite_count
                    .last_finite → last_finite  .total_notfinite → total_notfinite
                    .inner_state → (below)
  chain             [0] clip (no state), [1] adamw = (ScaleByAdamState, masked
                    decay, learning rate); with a trainable mask the chain is
                    the outer chain's [0] and the frozen-update mask its [1]
                    (no state)
  ScaleByAdamState  .count → count    .mu[...] → mu    .nu[...] → nu

so Adam's moments sit at ``['opt_state'].inner_state[1][0].mu['encoder']…``
in the default chain.  MultiSteps' skip state is empty.
``train_state_from_tree`` reads that layout, and the one the port wrote
before it (``['opt_state']['mu'|'nu'|'count'|'notfinite_count'|
'mini_step'|'acc_grads']``).

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

from matcha_tpu_torch.checkpoint import Attr, flatten_keystr
from matcha_tpu_torch.models.config import DiTConfig, MatchaConfig
from matcha_tpu_torch.train.optim import AdamW, OptState
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, params_to_jax, unflatten_tree

SPEAKER_TABLES = ("speaker_embeddings_enc", "speaker_embeddings_dur")


def save_tree(path: str | Path, tree: Mapping, cfg: MatchaConfig | DiTConfig) -> None:
    """A nested tree of arrays + its config → a flat checkpoint directory."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    flat = flatten_keystr(tree)
    np.savez(path / "state.npz", **{k: np.asarray(v) for k, v in flat.items()})
    (path / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))


def _i32(value) -> np.ndarray:
    return np.asarray(int(value), np.int32)


def optax_state_tree(opt_state: OptState, cfg: MatchaConfig | DiTConfig, *, skip_nonfinite: bool = True,
                     masked: bool = False) -> dict:
    """``OptState`` → the optax chain's state tree, keyed as the JAX trainer's
    (see the module docstring)."""
    node = {1: {0: {Attr("count"): _i32(opt_state.count),
                    Attr("mu"): params_to_jax(opt_state.mu, cfg),
                    Attr("nu"): params_to_jax(opt_state.nu, cfg)}}}
    if masked:
        node = {0: node}
    if skip_nonfinite:
        node = {Attr("notfinite_count"): _i32(opt_state.notfinite_count),
                Attr("last_finite"): np.asarray(bool(opt_state.last_finite)),
                Attr("total_notfinite"): _i32(opt_state.total_notfinite),
                Attr("inner_state"): node}
    if opt_state.acc_grads is not None:
        node = {Attr("mini_step"): _i32(opt_state.mini_step),
                Attr("gradient_step"): _i32(opt_state.gradient_step),
                Attr("inner_opt_state"): node,
                Attr("acc_grads"): params_to_jax(opt_state.acc_grads, cfg)}
    return node


def save_checkpoint(path: str | Path, params, opt_state: OptState, step: int, epoch: int,
                    cfg: MatchaConfig | DiTConfig, optimizer: AdamW | None = None) -> None:
    """A training state → a flat checkpoint in the JAX trainer's key paths.

    ``optimizer`` tells the chain's shape (finite check, trainable mask);
    without it, the default chain.  Accumulation shows in ``acc_grads``.
    """
    skip, masked = True, False
    if optimizer is not None:
        skip, masked = optimizer.cfg.skip_nonfinite_updates, optimizer.trainable is not None
    tree = {
        "params": params_to_jax(params, cfg),
        "opt_state": optax_state_tree(opt_state, cfg, skip_nonfinite=skip, masked=masked),
        "step": np.asarray(step, np.int64),
        "epoch": np.asarray(epoch, np.int64),
    }
    save_tree(path, tree, cfg)


def optax_state_parts(opt_tree: Mapping) -> tuple[Mapping, Mapping, Mapping]:
    """A checkpoint's ``opt_state`` subtree, in either layout → its Adam,
    finite-check and accumulation nodes (the last two empty when absent)."""
    if "mu" in opt_tree:  # the layout the port wrote before
        return opt_tree, opt_tree, opt_tree
    multi = finite = {}
    node = opt_tree
    if "inner_opt_state" in node:
        multi, node = node, node["inner_opt_state"]
    if "notfinite_count" in node:
        finite, node = node, node["inner_state"]
    if 0 in node:  # the chain sits inside the trainable-mask chain
        node = node[0]
    return node[1][0], finite, multi


def train_state_from_tree(tree: Mapping, cfg: MatchaConfig | DiTConfig, device, with_optimizer: bool = True):
    """A loaded checkpoint tree → (params, OptState or None, step, epoch).

    Tensors land on ``device``; params require grad.
    """
    def to_state(subtree):  # contiguous, as the card's optimizer takes them
        return {n: t.contiguous().to(device) for n, t in params_from_jax(subtree, cfg).items()}

    def scalar(value, dtype):
        return torch.tensor(np.asarray(value).item(), dtype=dtype, device=device)

    params = {n: t.requires_grad_(True) for n, t in to_state(tree["params"]).items()}
    opt_state = None
    if with_optimizer:
        adam, finite, multi = optax_state_parts(tree["opt_state"])
        opt_state = OptState(
            mu=to_state(adam["mu"]),
            nu=to_state(adam["nu"]),
            count=scalar(adam["count"], torch.int32),
            notfinite_count=scalar(finite.get("notfinite_count", 0), torch.int32),
            mini_step=int(multi.get("mini_step", 0)),
            acc_grads=to_state(multi["acc_grads"]) if "acc_grads" in multi else None,
            last_finite=scalar(finite.get("last_finite", True), torch.bool),
            total_notfinite=scalar(finite.get("total_notfinite", 0), torch.int32),
            gradient_step=int(multi.get("gradient_step", 0)),
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
