"""Device time of the masked-attention backward kernels of one checkout.

    python3 attention_bwd_timing.py [ROOT]

Imports ``matcha_tpu_torch`` from ROOT (default: the directory of this
file), builds its kernels, and times ``masked_attention_bwd_dkv`` and
``masked_attention_bwd_dq`` at the training path's two decoder shapes
(bf16, all keys valid), beside SDPA's backward (dq, dk, dv) on the same
inputs.  Prints one JSON line.  Needs a CUDA card.  To compare two
checkouts, run each in its own process (both build an extension of the
same name) in turns on one card: A, B, B, A.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from chip_smoke import cuda_ms

SHAPES = [(62, 5, 512, 64), (29, 5, 1088, 64)]


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root, "card": smi, "times_ms": {}}
    for shape in SHAPES:
        b, h, t, d = shape
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                         for _ in range(4))
        valid = torch.ones((b, t), device="cuda")
        valid_u8 = valid.to(torch.uint8)
        o, lse = att._launch_fwd(q, k, v, valid_u8, with_lse=True)
        delta = (dout.float() * o.float()).sum(-1)
        dkv = cuda_ms(lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8))
        dq = cuda_ms(lambda: att.masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8))
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=valid[:, None, None, :] > 0)
        sdpa = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True))
        out["times_ms"][str(list(shape))] = {"masked_attention_bwd_dkv": dkv, "masked_attention_bwd_dq": dq,
                                             "pair": dkv + dq, "sdpa_backward": sdpa}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
