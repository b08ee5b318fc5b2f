"""Tensor parallelism: Megatron-style column → row pairs over a (data, model) grid of ranks.

The port's counterpart of ``matcha_tpu/parallel/sharding.py``.  There GSPMD
partitions the jitted step from the parameters' shardings and inserts the
collectives; here they are explicit:

* **Grid.** ``make_mesh_2d(world, tp)`` lays the ranks out as ``(dp, tp)``
  with the model index varying fastest (rank = d·tp + m, as the JAX
  ``make_mesh_2d`` reshapes its devices), one tensor-parallel group per
  data index and one data-parallel group per model index.
* **Specs.** ``tp_param_specs`` gives each parameter of the port's
  state_dict the dimension it is split on, or ``None``: the JAX ``_RULES``
  applied to each parameter's flax path through the weight bridge's table
  (``weights.matcha_param_table``), the JAX package's
  indivisible-stays-replicated rule, and the torch layouts (``Linear``
  ``(out, in)``, ``Conv1d`` ``(out, in, k)``).  Two deliberate differences
  from the JAX specs: an attention pair (q, k, v → out) is split only by
  whole heads, so where the head count is not a multiple of ``tp`` the
  whole pair stays replicated (GSPMD may split a head and reshard; at
  ``MatchaConfig()``'s 5 decoder heads and ``tp=2`` the decoder's attention
  stays whole and its FFNs are split), and a column-parallel layer's bias
  is split with its kernel (the Conformer's q, k, v biases, which the JAX
  rules leave replicated).  The JAX rules split only the first two
  encoder FFNs (``ConvFFN_0``, ``ConvFFN_1``); so does the port.
* **Layers.** A column-parallel pair's input is the identity forward and
  an all-reduce over the group backward (``TPGroup.copy``); its
  row-parallel output is an all-reduce forward and the identity backward
  (``TPGroup.row_output``), with the bias added once, after the sum.
  ``apply_tensor_parallel`` marks the modules of a ``MatchaTTS`` whose
  parameters are split: decoder attention and SnakeBeta FFNs, Conformer
  attention, the encoder's RoPE attention (heads local, RoPE per head) and
  its conv FFNs (``conv_1`` split on its output channels, ``conv_2`` on
  its input channels, masks applied on each rank).
* **Dropout.** A mask over split channels is drawn whole from the
  generator and sliced (``models/layers.py::dropout``), so tensor-parallel
  peers consume their generators alike and the full-width masks after
  each pair agree across them.

The train step (``train/step.py``) sums loss denominators and gradients
over the data-parallel group, takes the global norm as the split
parameters' squares summed over the tensor-parallel group plus the
replicated ones counted once, and keeps Adam's moments split like their
parameters.  Checkpoints hold whole tensors (``gather_state``), which
``shard_state`` slices again on load.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.weights import matcha_param_table

_COLUMN = "column"  # shard output channels
_ROW = "row"        # shard input channels
_VECTOR = "vector"  # per-hidden-channel vector

# the JAX package's rules, verbatim (matcha_tpu/parallel/sharding.py:66-91):
# (flax path suffix, kind); flax layouts Dense (in, out), Conv (k, in, out)
_RULES: tuple[tuple[tuple[str, ...], str], ...] = (
    (("ff", "proj_in", "kernel"), _COLUMN),
    (("ff", "proj_in", "bias"), _VECTOR),
    (("ff", "alpha"), _VECTOR),
    (("ff", "beta"), _VECTOR),
    (("ff", "proj_out", "kernel"), _ROW),
    (("to_q", "kernel"), _COLUMN),
    (("to_k", "kernel"), _COLUMN),
    (("to_v", "kernel"), _COLUMN),
    (("to_out", "kernel"), _ROW),
    (("ConvFFN_0", "Conv_0", "kernel"), _COLUMN),
    (("ConvFFN_0", "Conv_0", "bias"), _VECTOR),
    (("ConvFFN_0", "Conv_1", "kernel"), _ROW),
    (("ConvFFN_1", "Conv_0", "kernel"), _COLUMN),
    (("ConvFFN_1", "Conv_0", "bias"), _VECTOR),
    (("ConvFFN_1", "Conv_1", "kernel"), _ROW),
    (("q", "kernel"), _COLUMN),
    (("q", "bias"), _VECTOR),
    (("k", "kernel"), _COLUMN),
    (("k", "bias"), _VECTOR),
    (("v", "kernel"), _COLUMN),
    (("v", "bias"), _VECTOR),
    (("out", "kernel"), _ROW),
)

# the torch dimension of each flax dimension, per layout kind of the bridge
_TORCH_DIM = {
    "copy": (0, 1, 2),
    "dense": (1, 0),             # (in, out) → (out, in)
    "dense_as_conv1x1": (1, 0),  # (in, out) → (out, in, 1)
    "conv": (2, 1, 0),           # (k, in, out) → (out, in, k)
    "convT": (2, 1, 0),          # (k, out, in) → (in, out, k)
}


def flax_shape(torch_shape: tuple[int, ...], kind: str) -> tuple[int, ...]:
    """The flax leaf's shape of a torch parameter of layout ``kind``."""
    if kind == "dense_as_conv1x1":
        return (torch_shape[1], torch_shape[0])
    if kind == "copy":
        return tuple(torch_shape)
    return tuple(reversed(torch_shape))


def jax_rule_dim(flax_path: str, shape: tuple[int, ...], tp: int) -> int | None:
    """The flax dimension the JAX rules split ``flax_path`` on, or None
    (``_spec_for``: first matching suffix; indivisible → replicated)."""
    names = tuple(flax_path.split("/"))
    for suffix, kind in _RULES:
        if names[-len(suffix):] == suffix:
            dim = 0 if kind == _VECTOR else len(shape) - 1 if kind == _COLUMN else len(shape) - 2
            if dim < 0 or shape[dim] % tp != 0:
                return None
            return dim
    return None


def _attention_heads(name: str, cfg: MatchaConfig) -> int | None:
    """The head count of the attention pair ``name`` belongs to, or None."""
    module = name.rsplit(".", 1)[0]
    if name.startswith("encoder.encoder.attn_layers."):
        return cfg.encoder.n_heads
    if name.startswith("decoder.estimator.") and module.endswith(
            (".to_q", ".to_k", ".to_v", ".to_out", ".to_out.0")):
        return cfg.decoder.num_heads
    return None


def _column_of(name: str) -> str | None:
    """The kernel whose output channels the bias ``name`` follows, for a
    column-parallel layer's bias the JAX rules do not name."""
    if name.endswith(".bias") and name.rsplit(".", 2)[-2] in ("to_q", "to_k", "to_v"):
        return name[: -len("bias")] + "weight"
    return None


def tp_param_specs(state_dict: Mapping[str, torch.Tensor], cfg: MatchaConfig, tp: int) -> dict[str, int | None]:
    """{parameter name: the torch dimension it is split on over ``tp``
    ranks, or None}, for a whole (unsplit) MatchaTTS state_dict."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    specs: dict[str, int | None] = {}
    for name, path, kind in matcha_param_table(cfg):
        shape = tuple(state_dict[name].shape)
        dim = jax_rule_dim(path, flax_shape(shape, kind), tp) if tp > 1 else None
        specs[name] = None if dim is None else _TORCH_DIM[kind][dim]
    for name in specs:
        heads = _attention_heads(name, cfg)
        if heads is not None and heads % tp:
            specs[name] = None  # whole heads only: the pair stays replicated
        column = _column_of(name)
        if column is not None and specs[name] is None and specs.get(column) == 0:
            specs[name] = 0
    return specs


@dataclass(frozen=True)
class Mesh2D:
    """This rank's place in the (dp, tp) grid and its two groups."""

    dp: int
    tp: int
    rank: int
    tp_group: object
    dp_group: object

    @property
    def d(self) -> int:
        """Data index: which block of every batch's rows this rank holds."""
        return self.rank // self.tp

    @property
    def m(self) -> int:
        """Model index: which block of each split parameter this rank holds."""
        return self.rank % self.tp

    @property
    def dp_root(self) -> int:
        """The global rank of data index 0 at this model index."""
        return self.m


def make_mesh_2d(world: int, tp: int) -> Mesh2D:
    """The (dp, tp) grid over a running process group of ``world`` ranks.

    Every rank creates every group, in one order (``dist.new_group`` is
    collective).  ``tp`` must divide ``world``."""
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide the world size {world}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("tensor parallelism needs a running process group")
    if dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, not {world}")
    dp = world // tp
    rank = dist.get_rank()
    tp_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    return Mesh2D(dp, tp, rank, tp_groups[rank // tp], dp_groups[rank % tp])


def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """Σ x over ``group``, summed in fp32 (float64 stays float64), in x's dtype."""
    wide = torch.promote_types(x.dtype, torch.float32)
    out = x.to(wide).contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_fp32(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TPGroup:
    """The tensor-parallel group as the model's layers use it."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = size
        self.index = index

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel pair's input."""
        return _CopyToTP.apply(x, self.group)

    def row_output(self, partial: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        """A row-parallel layer's output from this rank's wide-dtype partial
        product: summed over the group, the bias (in the compute dtype)
        added once, rounded once to the bias's dtype (or kept wide)."""
        y = _ReduceFromTP.apply(partial, self.group)
        if bias is None:
            return y
        return (y + bias.to(y.dtype)).to(bias.dtype)

    def shard(self, dim: int) -> tuple[int, int, int]:
        """``dropout``'s ``shard`` for a tensor split on ``dim``."""
        return (dim, self.index, self.size)


def apply_tensor_parallel(model: torch.nn.Module, specs: Mapping[str, int | None], tp: TPGroup) -> int:
    """Mark the modules of a ``MatchaTTS`` whose parameters ``specs`` split;
    returns how many pairs were marked.  The module keeps its whole-width
    parameters; ``torch.func.functional_call`` runs it with this rank's
    blocks (``shard_state``)."""
    from matcha_tpu_torch.models.decoder import Attention, ConformerBlock, FeedForward
    from matcha_tpu_torch.models.text_encoder import ConvFFN, RopeSelfAttention

    def split(prefix, column, row):
        c, r = specs[f"{prefix}.{column}"], specs[f"{prefix}.{row}"]
        if (c is None) != (r is None):
            raise ValueError(f"{prefix}: {column} and {row} must be split together ({c}, {r})")
        return c is not None

    pairs = 0
    for name, mod in model.named_modules():
        if isinstance(mod, Attention) and split(name, "to_q.weight", "to_out.0.weight"):
            mod.tp, mod.num_heads = tp, mod.num_heads // tp.size
            mod.to_out[0].row_parallel = tp
        elif isinstance(mod, ConformerBlock) and split(name, "to_q.weight", "to_out.weight"):
            mod.tp, mod.num_heads = tp, mod.num_heads // tp.size
            mod.to_out.row_parallel = tp
        elif isinstance(mod, FeedForward) and split(name, "net.0.proj.weight", "net.2.weight"):
            mod.tp = tp
            mod.net[2].row_parallel = tp
        elif isinstance(mod, RopeSelfAttention) and split(name, "conv_q.weight", "conv_o.weight"):
            mod.tp, mod.n_heads, mod.channels = tp, mod.n_heads // tp.size, mod.channels // tp.size
            mod.conv_o.row_parallel = tp
        elif isinstance(mod, ConvFFN) and split(name, "conv_1.weight", "conv_2.weight"):
            mod.tp = tp
            mod.conv_2.row_parallel = tp
        else:
            continue
        pairs += 1
    return pairs


def shard_tensor(t: torch.Tensor, dim: int | None, tp: int, m: int) -> torch.Tensor:
    """Block ``m`` of ``tp`` of ``t`` along ``dim`` (``t`` itself when None)."""
    if dim is None:
        return t
    size = t.shape[dim] // tp
    return t.narrow(dim, m * size, size).contiguous()


def shard_state(state: Mapping[str, torch.Tensor], specs: Mapping[str, int | None], tp: int,
                m: int) -> dict[str, torch.Tensor]:
    """This rank's blocks of a whole state (parameters or a moment)."""
    return {n: shard_tensor(t, specs[n], tp, m) for n, t in state.items()}


def gather_state(state: Mapping[str, torch.Tensor], specs: Mapping[str, int | None],
                 mesh: Mesh2D) -> dict[str, torch.Tensor]:
    """Whole tensors from every rank's blocks: an all-gather over the
    tensor-parallel group per split tensor, in name order on every rank."""
    out = {}
    for n, t in state.items():
        dim = specs[n]
        if dim is None or mesh.tp == 1:
            out[n] = t.detach()
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.tp)]
        dist.all_gather(parts, t.detach().contiguous(), group=mesh.tp_group)
        out[n] = torch.cat(parts, dim=dim)
    return out


def split_norm_sq(tensors: Mapping[str, torch.Tensor], specs: Mapping[str, int | None],
                  mesh: Mesh2D) -> torch.Tensor:
    """Σ t² over the whole tensors: the split ones' local sums all-reduced
    over the tensor-parallel group, the replicated ones counted once."""
    dev = next(iter(tensors.values())).device
    split = torch.zeros((), dtype=torch.float32, device=dev)
    whole = torch.zeros((), dtype=torch.float32, device=dev)
    for n, t in tensors.items():
        sq = t.float().square().sum()
        if specs[n] is None:
            whole = whole + sq
        else:
            split = split + sq
    if mesh.tp > 1:
        dist.all_reduce(split, op=dist.ReduceOp.SUM, group=mesh.tp_group)
    return split + whole
