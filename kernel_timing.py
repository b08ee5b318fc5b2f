"""Device time of every hand-written kernel of one checkout.

    python3 kernel_timing.py [ROOT]

Imports ``matcha_tpu_torch`` from ROOT (default: the directory of this
file), builds its kernels, and times, with CUDA events after a spin kernel
(``chip_smoke.cuda_ms``):

- the masked-attention forward (K1, bf16, all keys valid) at the B=1
  request's shapes, the B=16 batch's and, writing its log-sum-exp as the
  training step does, the training steps' (the DiT's too), beside SDPA's forward on the
  same inputs; where the checkout's wrapper takes a ``layout``, each bf16
  layout on its own as well; the encoder's training shape (62,6,224,48),
  the v20 decoder's (62,6,512,64) and their tensor-parallel halves
  (62,3,512,64), (62,3,224,48), each with and without the log-sum-exp;
- the backward (K1b) at the training shapes, those four included, and
  at the DiT's, beside SDPA's backward (dq, dk, dv): ``pair`` is the whole
  backward's device time, the fused pass with its delta pre-pass and dq
  post-pass, or a checkout's split pair (dk/dv kernel, then dq kernel;
  its PyTorch delta timed apart as ``delta``);
- monotonic alignment search (K2+K3) at the two training buckets.

Prints one JSON line.  Needs a CUDA card.  To compare two checkouts, run
each in its own process (both build an extension of the same family) in
turns on one card: A, B, B, A.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys

import torch

from chip_smoke import cuda_ms

NEW_SIGNATURES = [(62, 6, 224, 48), (62, 6, 512, 64), (62, 3, 512, 64), (62, 3, 224, 48)]
FWD_SHAPES = {"b1": [(1, 6, 256, 48), (1, 5, 512, 64), (1, 5, 256, 64)],
              "b16": [(16, 6, 256, 48), (16, 5, 512, 64), (16, 5, 256, 64)],
              "train": [(62, 5, 512, 64), (29, 5, 1088, 64)] + NEW_SIGNATURES,
              "no_lse": NEW_SIGNATURES}
DIT_SHAPES = [(13, 16, 2816, 64), (13, 16, 2848, 64), (52, 16, 736, 64), (50, 16, 768, 64)]
FWD_SHAPES["train"] += DIT_SHAPES
BWD_SHAPES = [(62, 5, 512, 64), (29, 5, 1088, 64)] + NEW_SIGNATURES + DIT_SHAPES
MAS_SHAPES = [(62, 224, 1024), (29, 448, 2176)]


def time_forward(att, gen, layouts) -> dict:
    import torch.nn.functional as F

    out = {}
    for group, shapes in FWD_SHAPES.items():
        with_lse = group == "train"
        for shape in shapes:
            b, h, t, d = shape
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                       for _ in range(3))
            valid_u8 = torch.ones((b, t), device="cuda", dtype=torch.uint8)
            keep = valid_u8[:, None, None, :] > 0
            entry = {"masked_attention_fwd": cuda_ms(lambda: att._launch_fwd(q, k, v, valid_u8, with_lse)),
                     "sdpa_forward": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))}
            for layout in layouts:
                entry[f"layout_{layout}"] = cuda_ms(
                    lambda: att._launch_fwd(q, k, v, valid_u8, with_lse, layout=layout))
            out[f"{group} {list(shape)}"] = entry
    return out


def time_backward(att, gen) -> dict:
    import torch.nn.functional as F

    out = {}
    for shape in BWD_SHAPES:
        b, h, t, d = shape
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                         for _ in range(4))
        valid = torch.ones((b, t), device="cuda")
        valid_u8 = valid.to(torch.uint8)
        o, lse = att._launch_fwd(q, k, v, valid_u8, with_lse=True)
        if hasattr(att, "masked_attention_bwd_count"):  # one launch: delta, dq, dk, dv
            pair = cuda_ms(lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, o, valid_u8))
            entry = {}
        else:  # the split pair, delta computed outside it
            delta = (dout.float() * o.float()).sum(-1)
            entry = {"masked_attention_bwd_dkv": cuda_ms(
                         lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8)),
                     "masked_attention_bwd_dq": cuda_ms(
                         lambda: att.masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8)),
                     "delta": cuda_ms(lambda: (dout.float() * o.float()).sum(-1))}
            pair = entry["masked_attention_bwd_dkv"] + entry["masked_attention_bwd_dq"]
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=valid[:, None, None, :] > 0)
        sdpa = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True))
        out[str(list(shape))] = {**entry, "pair": pair, "sdpa_backward": sdpa}
    return out


def time_mas(mas, gen) -> dict:
    out = {}
    for shape in MAS_SHAPES:
        b, tx, ty = shape
        value = torch.randn(shape, generator=gen, device="cuda") * 3.0
        x_len = torch.full((b,), tx, device="cuda")
        y_len = torch.full((b,), ty, device="cuda")
        out[str(list(shape))] = {"mas": cuda_ms(lambda: mas.maximum_path_indices_kernel(value, x_len, y_len))}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from matcha_tpu_torch.ops import attention as att
    from matcha_tpu_torch.ops import mas

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    layouts = (1, 2) if "layout" in inspect.signature(att._launch_fwd).parameters else ()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root, "card": smi, "times_ms": {
        "forward": time_forward(att, gen, layouts),
        "backward": time_backward(att, gen),
        "mas": time_mas(mas, gen)}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
