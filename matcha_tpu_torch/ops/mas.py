"""Monotonic alignment search: a hand-written Hopper kernel and its plain version.

Counterpart of ``matcha_tpu/ops/mas.py`` (``maximum_path_numpy``,
``maximum_path_indices``, ``durations_from_indices``, ``maximum_path`` and
the backend dispatch of ``maximum_path_indices_auto``).  All fp32: bf16
cannot tell near-tied alignment paths apart.

Semantics (``mas_pallas.py::_fwd_kernel`` / ``_bwd_kernel``): for each mel
frame j, f[i] ← v[i, j] + max(f[i], f[i−1]) with f[−1] = −1e9; rows
i ≥ x_len are held at −1e9; at j = 0 only f[0] = v[0, 0]; f freezes for
j ≥ y_len; take_diag[j, i] = (f[i−1] ≥ f[i]), ties going diagonal.  The
backtrack starts at x_len − 1, emits the cursor for j < y_len and −1 after,
and steps down when j < y_len, j > 0, cursor > 0 and take_diag holds.
Lengths must lie in [1, Tx] and [0, Ty].

Kernel note.  ``maximum_path_indices_kernel`` launches the CUDA C++ kernel
in ``csrc/mas.cu``, which replaces both Pallas TPU kernels of
``matcha_tpu/ops/mas_pallas.py`` (the forward DP launched at :179, the
backtrack at :189) with one launch: one block per batch row, in which one
warp holds the whole DP front in registers (Tx <= 512, a run of
consecutive tokens per lane; no block barrier per frame) while three
loader warps copy the values into a ring of 16-frame tiles ahead of it;
the decisions are packed as bits, and the backtrack jumps from one
step to the next.  Longer texts take a block-wide kernel with one barrier
per frame.  Every
operation is an fp32 add or max in the scan's order, so the kernel's
indices equal the plain version's exactly.

Dispatch.  ``backend`` takes the names a config can carry: "auto",
"pallas" and "pallas_shard_map" send a CUDA tensor to the kernel (a CPU
tensor to the plain version); "scan" asks for the plain version on any
device.  A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tpu_torch.ops.extension import LaunchCounter, kernels

NEG_INF = -1e9
BACKENDS = ("auto", "pallas", "pallas_shard_map", "scan")

mas_count = LaunchCounter("mas")


def maximum_path_numpy(value: np.ndarray, x_len: int, y_len: int) -> np.ndarray:
    """Textbook DP oracle for one (Tx, Ty) log-prior matrix → binary path.

    Starts at (0, 0), ends at (x_len−1, y_len−1); each mel frame advances
    the text index by 0 or 1.
    """
    t_x, t_y = value.shape
    f = np.full((t_x, t_y), -np.inf, dtype=np.float64)
    f[0, 0] = value[0, 0]
    for j in range(1, y_len):
        for i in range(min(j + 1, x_len)):
            stay = f[i, j - 1]
            diag = f[i - 1, j - 1] if i > 0 else -np.inf
            f[i, j] = value[i, j] + max(stay, diag)
    path = np.zeros((t_x, t_y), dtype=np.float32)
    i = x_len - 1
    for j in range(y_len - 1, -1, -1):
        path[i, j] = 1.0
        if i > 0 and (i == j or f[i - 1, j - 1] >= f[i, j - 1]):
            i -= 1
    return path


def maximum_path_indices_plain(value, x_lengths, y_lengths):
    """(B, Tx, Ty) fp32 log-priors → (B, Ty) int32 token index per frame.

    A loop over mel frames, vectorised over (B, Tx); −1 on frames past
    ``y_lengths``.
    """
    value = value.float()
    b, t_x, t_y = value.shape
    dev = value.device
    x_len = x_lengths.to(device=dev, dtype=torch.int64)
    y_len = y_lengths.to(device=dev, dtype=torch.int64)
    rows = torch.arange(t_x, device=dev)
    row_valid = rows[None, :] < x_len[:, None]
    neg = torch.full((b, 1), NEG_INF, device=dev)

    f = torch.where((rows[None, :] == 0) & row_valid, value[:, :, 0], NEG_INF)
    decisions = torch.zeros((t_y, b, t_x), dtype=torch.bool, device=dev)
    for j in range(1, t_y):
        shifted = torch.cat([neg, f[:, :-1]], dim=1)
        decisions[j] = shifted >= f
        f_new = torch.where(row_valid, value[:, :, j] + torch.maximum(f, shifted), NEG_INF)
        f = torch.where((j < y_len)[:, None], f_new, f)

    idx = torch.empty((b, t_y), dtype=torch.int32, device=dev)
    cursor = x_len - 1
    for j in range(t_y - 1, -1, -1):
        active = j < y_len
        idx[:, j] = torch.where(active, cursor, -1).to(torch.int32)
        took = decisions[j].gather(1, cursor.clamp(0, t_x - 1)[:, None])[:, 0]
        step = active & (j > 0) & (cursor > 0) & took
        cursor = cursor - step.to(torch.int64)
    return idx


def _check_kernel_inputs(value, x_lengths, y_lengths):
    if value.dim() != 3:
        raise ValueError(f"value must be (B, Tx, Ty), got {tuple(value.shape)}")
    b = value.shape[0]
    for name, t in (("x_lengths", x_lengths), ("y_lengths", y_lengths)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be (B,) = ({b},), got {tuple(t.shape)}")
        if t.device != value.device:
            raise ValueError(f"{name} must be on value's device")


def maximum_path_indices_kernel(value, x_lengths, y_lengths):
    """The kernel's wrapper; on a CPU tensor, the plain version."""
    if not value.is_cuda:
        return maximum_path_indices_plain(value, x_lengths, y_lengths)
    _check_kernel_inputs(value, x_lengths, y_lengths)
    b, t_x, t_y = value.shape
    ext = kernels()
    value = value.float().contiguous()
    idx = torch.empty((b, t_y), dtype=torch.int32, device=value.device)
    words = ext.mas_scratch_words(b, t_x, t_y)
    scratch = torch.empty((words,), dtype=torch.int32, device=value.device)
    ext.mas_indices(value, x_lengths.to(torch.int32).contiguous(),
                    y_lengths.to(torch.int32).contiguous(), idx, scratch)
    mas_count.add((b, t_x, t_y))
    return idx


def maximum_path_indices(value, x_lengths, y_lengths, backend: str = "auto"):
    """Backend-dispatched MAS: (B, Tx, Ty) → (B, Ty) int32, −1 on padding."""
    if backend not in BACKENDS:
        raise ValueError(f"Unknown MAS backend {backend!r}; choose from {BACKENDS}")
    if backend == "scan":
        return maximum_path_indices_plain(value, x_lengths, y_lengths)
    return maximum_path_indices_kernel(value, x_lengths, y_lengths)


def durations_from_indices(idx, t_x: int):
    """(B, Ty) frame→token indices → (B, Tx) fp32 frame counts per token."""
    idx = idx.long()
    out = torch.zeros((idx.shape[0], t_x), dtype=torch.float32, device=idx.device)
    return out.scatter_add_(1, idx.clamp(min=0), (idx >= 0).float())


def maximum_path(value, x_lengths, y_lengths, backend: str = "auto"):
    """Dense-path MAS: (B, Tx, Ty) binary alignment."""
    idx = maximum_path_indices(value, x_lengths, y_lengths, backend).long()
    t_x = value.shape[1]
    path = (idx[:, :, None] == torch.arange(t_x, device=idx.device)).float()
    return path.transpose(1, 2)
