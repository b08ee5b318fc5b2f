"""Data parallelism across processes: one process per device, one group.

The port's counterpart of ``matcha_tpu/parallel/mesh.py``.  The JAX package
shards the batch on the ``data`` axis of a device mesh and lets XLA insert
the gradient all-reduce; here each process (one per card, as ``torchrun``
starts them) holds a full replica of the parameters and optimizer state,
takes one contiguous block of every batch's rows, and the train step sums
the loss denominators and the gradients over the group with
``torch.distributed`` (``train/step.py``).  The model is ~30-60 M
parameters, so data parallelism is the recommended scaling strategy, as in
the JAX package (``matcha_tpu/parallel/sharding.py:20-23``); tensor
parallelism over a (data, model) grid of ranks, for width-scaled
variants, is ``parallel/sharding.py``, whose data-parallel groups these
collectives take as ``group``.

Backends: ``nccl`` for the card, ``gloo`` for the CPU, and ``gloo`` on the
card only when asked for (two ranks sharing one card, which NCCL refuses).
A process group that fails to start raises: a run asked to be data-parallel
never goes on as a single process.
"""

from __future__ import annotations

import os
from collections.abc import Mapping, Sequence
from datetime import timedelta

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def env_world_size() -> int:
    """``WORLD_SIZE`` as torchrun sets it; 1 when unset."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_data_parallel(device: torch.device | str, *, backend: str | None = None,
                       init_method: str = "env://", rank: int | None = None,
                       world_size: int | None = None, timeout_s: float = 600.0) -> None:
    """Start the default process group.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to its ``MASTER_ADDR``/``MASTER_PORT``
    store (``tcp://host:port`` and ``file://path`` work too).  ``backend``
    defaults to ``nccl`` on the card and ``gloo`` on the CPU; ``gloo`` on
    the card must be asked for.  Raises if the group does not start.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl needs CUDA tensors: use backend='gloo' on the CPU")
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = env_world_size() if world_size is None else world_size
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s), **kwargs)


def active() -> bool:
    """Whether a process group is running."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def row_block(n_rows: int, rank: int, world: int) -> slice:
    """The contiguous block of ``n_rows`` that ``rank`` takes, as
    ``P(DATA_AXIS)`` splits the batch axis; ``world`` must divide ``n_rows``."""
    if n_rows % world:
        raise ValueError(f"{n_rows} rows do not split over {world} ranks")
    per = n_rows // world
    return slice(rank * per, (rank + 1) * per)


def shard_rows(batch, rank: int, world: int):
    """``rank``'s block of rows of a tensor, or of each tensor of a tuple
    (a ``Batch``; ``None`` fields stay ``None``)."""
    if isinstance(batch, torch.Tensor):
        return batch[row_block(batch.shape[0], rank, world)]
    rows = row_block(next(t for t in batch if t is not None).shape[0], rank, world)
    return type(batch)(*(None if t is None else t[rows] for t in batch))


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``tensor`` over ``group`` (default: the whole group), as a new
    tensor (the input is kept)."""
    out = tensor.clone()
    if active():
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group`` in place, in one collective: flattened
    into one fp32 buffer, reduced, copied back."""
    if not active() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()


def broadcast_state(tensors: Mapping[str, torch.Tensor], src: int = 0, group=None) -> None:
    """Global rank ``src``'s values into the tensors of every rank of
    ``group`` (default: the whole group), in place."""
    if not active():
        return
    with torch.no_grad():
        for t in tensors.values():
            dist.broadcast(t, src=src, group=group)


def barrier() -> None:
    if active():
        dist.barrier()


def destroy() -> None:
    if active():
        dist.destroy_process_group()
