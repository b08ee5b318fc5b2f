"""K1 with lse and K1b of the flow estimator: bounds of their launches in the traced slice over their device time, in %; a chunk-causal launch's bound counts only the (query, key) pairs its mask keeps."""

import numpy as np

from benchmark import roofline

KINDS = ("fwd", "dkv", "dq")


def kept_keys(masks, t: int, chunk: int) -> float:
    """Σ over batch rows and queries of the keys a query sees, over T: the
    ``valid_keys`` whose 4·H·T·D·valid_keys flops are the launch's."""
    lengths = (masks > 0).sum(dim=1).cpu().numpy().astype(np.int64)
    if not chunk:
        return float(lengths.sum())
    ends = (np.arange(t) // chunk + 1) * chunk
    return float(np.minimum(lengths[:, None], ends[None]).sum()) / t


def read(run):
    t = run.traced
    chunks = run.extra.get("launch_chunks")
    if t is None or chunks is None:
        return None
    launches = [x for x in t["launches"] if x[0] in KINDS]
    if len(launches) != len(chunks) or not launches:
        return None
    device = roofline.kernel_device_s(t, KINDS)
    if device <= 0:
        return None
    total = 0.0
    for (kind, shape, dtype, with_lse, masks), (ckind, chunk) in zip(launches, chunks):
        if kind != ckind:
            return None
        keys = kept_keys(masks, shape[2], chunk)
        if kind == "fwd":
            total += roofline.attention_fwd_s(shape, dtype, keys, with_lse)
        elif kind == "dkv":
            total += roofline.attention_bwd_s(shape, dtype, keys, 5, 8)
    return 100.0 * total / device
