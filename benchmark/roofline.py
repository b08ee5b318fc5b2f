"""Least times of the hand-written kernels, from their shapes and inputs.

Frozen copies of the bounds the program's ``chip_smoke.py`` uses
(``attention_bound_ms``, ``attention_bwd_bound_ms``, ``mas_bound_ms``),
counting the keys that are valid in each row, as the inputs need them:
each input byte read once, each output byte written once; the products at
the dtype's peak.  A share of the roofline is the sum of these bounds over
the launches of a traced slice, over the kernels' device time in it.
"""

from __future__ import annotations

from benchmark.harness import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS

# substrings of the kernels' names in a device trace
KERNEL_NAMES = {
    "fwd": ("masked_attention_fwd",),
    "dkv": ("attn_bwd_dkv",),
    "dq": ("attn_bwd_dq",),
    "mas": ("mas_kernel", "mas_wide_kernel"),
}


def _elem(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def _peak(dtype: str) -> float:
    return PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS


def attention_fwd_s(shape, dtype: str, valid_keys: int, with_lse: bool) -> float:
    """q, k, v read and out (and the fp32 lse) written once, the (B, T)
    mask read once; 4·H·T·D flops for every (query, valid key) pair."""
    b, h, t, d = shape
    nbytes = 4 * b * h * t * d * _elem(dtype) + b * t + (4 * b * h * t if with_lse else 0)
    flops = 4 * h * t * d * valid_keys
    return max(nbytes / PEAK_BYTES, flops / _peak(dtype))


def attention_bwd_s(shape, dtype: str, valid_keys: int, products: int, tensors: int) -> float:
    """``products`` matrix products of 2·H·T·D flops for every (query,
    valid key) pair; ``tensors`` (B, H, T, D) tensors read or written once,
    the fp32 lse and delta rows and the mask."""
    b, h, t, d = shape
    nbytes = tensors * b * h * t * d * _elem(dtype) + 2 * b * h * t * 4 + b * t
    flops = 2 * products * h * t * d * valid_keys
    return max(nbytes / PEAK_BYTES, flops / _peak(dtype))


def mas_s(valid_cells: int, rows: int, ty: int) -> float:
    """The valid log-prior cells read once, the indices written once; the
    DP's adds and maxes at the fp32 peak."""
    nbytes = valid_cells * 4 + rows * ty * 4 + 2 * rows * 4
    return max(nbytes / PEAK_BYTES, 2 * valid_cells / PEAK_FP32_FLOPS)


def launch_bound_s(launch) -> float:
    """The least time of one recorded launch (``harness.Tracer``)."""
    kind, shape, dtype, with_lse, masks = launch
    if kind == "mas":
        x_len, y_len = (m.long().cpu() for m in masks)
        return mas_s(int((x_len * y_len).sum()), shape[0], shape[2])
    valid = int((masks > 0).sum())  # Σ over rows of the valid keys
    if kind == "fwd":
        return attention_fwd_s(shape, dtype, valid, with_lse)
    if kind == "dkv":
        # the backward as a pair (chip_smoke.py's pair bound): it needs five
        # products (S, dP, dV, dK, dQ), q, k, v, dO read and dq, dk, dv
        # written once; the dq kernel's recomputation is not a need
        return attention_bwd_s(shape, dtype, valid, 5, 8)
    return 0.0  # dq: counted in its dkv launch's pair


def kernel_device_s(traced: dict, kinds) -> float:
    names = [s for k in kinds for s in KERNEL_NAMES[k]]
    return sum(v["s"] for name, v in traced["kernels"].items() if any(s in name for s in names))


def share(traced: dict | None, kinds) -> float | None:
    """Σ bounds / Σ device time of ``kinds`` in the traced slice, in %;
    None where the slice launched none of them."""
    if traced is None:
        return None
    launches = [x for x in traced["launches"] if x[0] in kinds]
    device = kernel_device_s(traced, kinds)
    if not launches or device <= 0:
        return None
    return 100.0 * sum(launch_bound_s(x) for x in launches) / device
