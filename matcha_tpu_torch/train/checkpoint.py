"""Training checkpoints in the flat format the port's reader loads.

``save_checkpoint`` writes a directory with ``config.json`` (the full
MatchaConfig) and ``state.npz``: one array per leaf, keyed by its jax key
path as ``matcha_tpu/train/checkpoint.py`` writes it without orbax.  The
parameters are in the flax layout (``weights.params_to_jax``), so
``matcha_tpu_torch.checkpoint.load_synthesizer`` serves a checkpoint the
port trained and the JAX package's models take its ``params`` tree.  Adam's
moments sit under ``['opt_state']['mu'|'nu']`` in the same layout, the
optimizer's counters under ``['opt_state'][...]``, and ``['step']``,
``['epoch']`` at the top.  Speaker-table expansion, averaging and stripping
are not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.checkpoint import load_checkpoint
from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.train.optim import OptState
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, params_to_jax


def _keystr(path: str) -> str:
    return "".join(f"['{p}']" for p in path.split("/"))


def save_checkpoint(path: str | Path, params, opt_state: OptState, step: int, epoch: int,
                    cfg: MatchaConfig) -> None:
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
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
    flat = flatten_tree(tree)
    np.savez(path / "state.npz", **{_keystr(k): v for k, v in flat.items()})
    (path / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))


def load_train_state(path: str | Path, device, with_optimizer: bool = True):
    """Checkpoint directory → (params, OptState or None, step, epoch, cfg).

    Tensors land on ``device``; params require grad.
    """
    tree, cfg = load_checkpoint(path)

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
    return params, opt_state, int(tree["step"]), int(tree["epoch"]), cfg
