"""Multi-tensor AdamW: the wrapper of two hand-written kernels and the tables they walk.

The kernels (``csrc/adamw.cu``) apply ``train/optim.py``'s chain (global-norm
clip, AdamW, the non-finite skip) to every parameter at once: the norm in two
launches (one with the norm given, as tensor parallelism gives it), the
update in one, plus one copy of the leaf table to the card, however many
parameters there are.  They replace no Pallas kernel: XLA fused the optax
chain into the TPU's step.  Their plain twin is ``AdamW.apply_plain``, the
loop the CPU runs; on the card the kernels give its p, mu and nu for the same
norm (the same fp32 operations in the same order), and a norm summed in
another order.

Tables (int64, written here, read by the kernels):

  leaves  (L, 4)  the addresses of p, g, mu, nu of each parameter, in the
                  parameters' order; written again on every call, since
                  ``autograd.grad`` returns new gradient tensors
  chunks  (C, 4)  (leaf, first element, element count, flags): every
                  element of every parameter in exactly one chunk of at most
                  ``CHUNK``; flags ``DECAY`` | ``TRAINABLE``.  Kept on the
                  card until the parameters or moments move.

The leaf table reaches the card through pinned memory from PyTorch's caching
host allocator, copied without blocking: the allocator hands the block out
again only once the copy has run, so a table in flight is never
overwritten, and the host never waits for the card.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from matcha_tpu_torch.ops.extension import LaunchCounter, kernels

CHUNK = 1 << 14  # elements a block of either kernel takes
SCALARS = 8      # out[0] the norm, out[1..4] the step's flags and bias corrections; partial sums after
DECAY, TRAINABLE = 1, 2

adamw_norm_count = LaunchCounter("adamw_norm")
adamw_update_count = LaunchCounter("adamw_update")


def leaf_flags(names: Sequence[str], decay: Mapping[str, bool],
               trainable: Mapping[str, bool] | None) -> list[int]:
    """Each parameter's chunk flags: ``DECAY`` on the weight-decay mask,
    ``TRAINABLE`` unless the trainable mask freezes it."""
    return [(DECAY if decay[n] else 0) | (TRAINABLE if trainable is None or trainable[n] else 0)
            for n in names]


def chunk_table(numels: Sequence[int], flags: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """(C, 4) int64 rows (leaf, start, count, flags) that cover every element
    of every leaf once, in order: a leaf of n elements takes ceil(n / chunk)
    rows, the last one short."""
    rows = [(leaf, start, min(chunk, n - start), f)
            for leaf, (n, f) in enumerate(zip(numels, flags))
            for start in range(0, n, chunk)]
    return np.array(rows, dtype=np.int64).reshape(-1, 4)


def leaf_pointers(what: str, tensors: Sequence[torch.Tensor], numels: Sequence[int],
                  device: torch.device) -> list[int]:
    """The tensors' addresses; raises ValueError on one the kernels cannot
    take: not float32, not contiguous, another size than its parameter, or
    on another device."""
    index = device.index if device.type == "cuda" else -1
    ptrs = []
    for i, (t, n) in enumerate(zip(tensors, numels)):
        if t.dtype is not torch.float32 or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"{what}[{i}] must be a contiguous float32 tensor of {n} elements, "
                             f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
        if t.get_device() != index:
            raise ValueError(f"{what}[{i}] lies on {t.device}, the parameters on {device}")
        ptrs.append(t.data_ptr())
    return ptrs


class FusedAdamW:
    """The kernels over one optimizer's parameters: ``step`` is one update.

    Keeps the chunk table on the card and the leaf table's p, mu and nu
    columns, both made again when a parameter or moment moves."""

    def __init__(self, decay: Mapping[str, bool], trainable: Mapping[str, bool] | None = None):
        self.decay = decay
        self.trainable = trainable
        self._key = None
        self._rows = None    # (L, 4) int64 on the host: p, (g), mu, nu addresses
        self._chunks = None  # (C, 4) int64 on the card
        self._numels = None

    def _prepare(self, key, names, ps, mus, nus, device) -> None:
        numels = [p.numel() for p in ps]
        rows = np.zeros((len(names), 4), dtype=np.int64)
        for col, (what, ts) in zip((0, 2, 3), (("params", ps), ("mu", mus), ("nu", nus))):
            rows[:, col] = leaf_pointers(what, ts, numels, device)
        chunks = torch.from_numpy(chunk_table(numels, leaf_flags(names, self.decay, self.trainable)))
        if device.type == "cuda":
            chunks = chunks.pin_memory().to(device, non_blocking=True)
        self._key, self._rows, self._chunks, self._numels = key, rows, chunks, numels

    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor], state, cfg,
             max_errors: int, norm: torch.Tensor | None = None) -> torch.Tensor:
        """One update of ``params`` and ``state`` (an ``OptState``: mu, nu and
        the four device scalars, in place) by ``cfg`` (an ``OptimizerConfig``,
        ``accumulate_grad_batches`` aside), accepting a non-finite gradient
        after ``max_errors`` in a row; ``norm``: the global norm to clip by, a
        device scalar (None: the gradients').  Returns the norm, a device
        scalar.  Raises ValueError on a tensor the kernels cannot take, CPU
        tensors included: it never falls back to the loop."""
        names = list(params)
        ps = [params[n] for n in names]
        mus = [state.mu[n] for n in names]
        nus = [state.nu[n] for n in names]
        device = ps[0].device
        key = (device, tuple(names), tuple(map(torch.Tensor.data_ptr, ps)),
               tuple(map(torch.Tensor.data_ptr, mus)), tuple(map(torch.Tensor.data_ptr, nus)))
        if key != self._key:
            self._prepare(key, names, ps, mus, nus, device)
        gptrs = leaf_pointers("grads", [grads[n] for n in names], self._numels, device)
        if device.type != "cuda":
            raise ValueError(f"the fused AdamW runs on a CUDA device, the parameters lie on {device}")
        ext = kernels()
        host = torch.empty(self._rows.shape, dtype=torch.int64, pin_memory=True)
        rows = host.numpy()
        rows[:] = self._rows
        rows[:, 1] = gptrs
        leaves = host.to(device, non_blocking=True)
        n_chunks = self._chunks.shape[0]
        out = torch.empty(SCALARS + n_chunks, dtype=torch.float32, device=device)
        given = torch.empty(0, dtype=torch.float32, device=device) if norm is None else norm.float()
        ext.adamw_norm(leaves, self._chunks, out, given, state.count, state.notfinite_count,
                       state.last_finite, state.total_notfinite, cfg.grad_clip, cfg.b1, cfg.b2,
                       cfg.skip_nonfinite_updates, max_errors)
        adamw_norm_count.add((len(names), n_chunks, norm is not None))
        ext.adamw_update(leaves, self._chunks, out, cfg.lr, cfg.b1, cfg.b2, cfg.eps,
                         cfg.weight_decay, cfg.grad_clip)
        adamw_update_count.add((len(names), n_chunks))
        return out[0]
