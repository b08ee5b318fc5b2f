"""Attribute stage B's device time to its components on the card.

The port's counterpart of ``tools/profile_stage_b.py``.  Stage B (alignment
→ CFM ODE → Vocos) is split across:

    align      prior assembly: duration cumsum → searchsorted gather →
               downsample → masks (``inference.align_prior``)
    unet_eval  ONE decoder (U-Net) evaluation; the ODE runs 2·steps of
               these (8 at the production midpoint/4 operating point)
    ode        the full 4-step midpoint integration (8 U-Net evaluations)
    vocos      ConvNeXt backbone + ISTFT head
    stage_b    the whole of ``_Replica.decode`` (a sum check)

and, inside one U-Net evaluation, the model's own blocks alone: a
transformer block at the decoder's T and T/2 (``tblock_hi``/``_lo``), a
ResnetBlock1D (``resnet_hi``/``_lo``), the SnakeBeta FFN (``ffn_*``), the
masked attention (``attn_*``), the snake's sin² alone (``sin_hi``) and
the FFN's two matmuls without it (``ffn_linear_hi``).

Each component's device time comes from ``utils/probe.inner_repeat``: the
chain of k calls is captured as one CUDA graph and replayed, so
``device_ms = (wall_k − wall_1) / (k − 1)``.  Each body sums every output
of its component in full (the probe's honesty rule, ``consume``).  A
component that cannot be captured raises with the reason; it is never
timed eagerly in its place.  Beside each time: the component's analytic
FLOP (``utils/flops.py``), its share of one whole request's
``synthesis_flops`` and its TFLOP/s.  Stage A's outputs come from a real
encoder run with the duration head pinned at 4 fine frames a token
(``bench.pin_durations``), so the bucket is full of speech.

Usage:
    python -m matcha_tpu_torch.utils.profile_stage_b [--batch 16] [--tx 256]
        [--fine 1024] [--k 4] [--reps 5] [--compute_dtype bfloat16]
        [--attention_backend auto] [--components align,unet_eval,ode,vocos,stage_b]

Prints one JSON line.  ``--device cpu --tiny`` runs the chains eagerly on
the CPU at tiny widths, for the tests: times are then ``cpu_ms``, and the
device fields are null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

DEFAULT_COMPONENTS = "align,unet_eval,ode,vocos,stage_b"
ALL_COMPONENTS = (*DEFAULT_COMPONENTS.split(","), "tblock_hi", "tblock_lo", "resnet_hi", "resnet_lo",
                  "ffn_hi", "ffn_lo", "attn_hi", "attn_lo", "sin_hi", "ffn_linear_hi")


def consume(outs) -> torch.Tensor:
    """The probe's scalar: every element of every output, summed in full
    (×1e-12, so that the chain's perturbation stays small)."""
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    return sum(o.float().sum() for o in outs) * 1e-12


def components(synth, cfg, vcfg, b: int, tx: int, fine: int) -> dict:
    """{name: (fn, args, flops)}: ``fn(acc, *args)`` runs the component with
    its input perturbed by the 0-d ``acc`` and returns its outputs;
    ``flops`` is its analytic forward count."""
    from matcha_tpu_torch.inference import align_prior
    from matcha_tpu_torch.ops.attention import masked_self_attention
    from matcha_tpu_torch.utils import flops as F

    rep = synth.replicas[0]
    dev, model = rep.device, rep.model
    est = model.decoder.estimator
    dt, carry = est.dtype, est.carry
    coarse = F.coarse_frames(fine)
    evals = F.unet_evaluations(4, "midpoint")
    rng = np.random.default_rng(0)

    def randn(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    # stage B's inputs from a real stage-A run
    x = torch.from_numpy(rng.integers(0, 600, (b, tx))).to(dev)
    lengths = torch.full((b,), tx, dtype=torch.int64, device=dev)
    spk = torch.zeros((b, cfg.spk_emb_dim), device=dev)
    mu_x, durations, x_mask = rep.encode(x, lengths, spk, spk, torch.ones((b, 1), device=dev))
    totals = torch.clamp(durations.sum(dim=1).to(torch.int64), 2, fine)
    mu_y = randn(b, coarse, cfg.n_feats)
    y_mask = torch.ones((b, coarse), device=dev)
    mel = randn(b, coarse, cfg.n_feats)
    noise = rep.noise(b, coarse)
    half = torch.full((b,), 0.5, device=dev)

    def align(acc, mu_x, durations, totals):
        return align_prior(mu_x + acc, durations, totals, fine)

    def unet_eval(acc, mu_y, y_mask):
        return est(mu_y + acc, y_mask, mu_y, half, masked_norm=True)

    def ode(acc, mu_y, y_mask):
        return model.decode(mu_y + acc, y_mask, 4, "midpoint", noise=noise)

    def vocos(acc, mel):
        return rep.vocos(mel + acc)

    def stage_b(acc, mu_x, durations, x_mask, totals):
        return rep.decode(mu_x + acc, durations, x_mask, totals, y_fine_len=fine, n_timesteps=4, solver="midpoint")

    unet = F.forward_flops(F.decoder_products(cfg, b, coarse))
    voc = F.forward_flops(F.vocos_products(vcfg, b, coarse))
    out = {
        "align": (align, (mu_x, durations, totals), 0.0),
        "unet_eval": (unet_eval, (mu_y, y_mask), unet),
        "ode": (ode, (mu_y, y_mask), evals * unet),
        "vocos": (vocos, (mel,), voc),
        "stage_b": (stage_b, (mu_x, durations, x_mask, totals), evals * unet + voc),
    }

    # the model's own blocks alone: one production evaluation runs 4
    # transformer blocks at T and 8 at T/2, 2 resnet blocks at T and 4 at T/2
    ch = cfg.decoder.channels[-1]
    resnet, tblocks = est.mid_blocks[0]
    tblock = tblocks[0]
    nh, hd = cfg.decoder.num_heads, cfg.decoder.attention_head_dim
    ted = 4 * cfg.decoder.channels[0]
    temb = randn(b, ted, dtype=dt)
    w1, w2 = randn(ch, 4 * ch, dtype=dt) * 0.02, randn(4 * ch, ch, dtype=dt) * 0.02

    def block_fn(block, with_temb):
        def fn(acc, h, m):
            return block(h + acc, m, temb) if with_temb else block(h + acc, m)
        return fn

    def ffn(acc, h):
        return tblock.ff(h + acc)

    def attn(acc, q, m):
        q = q + acc.to(q.dtype)
        return masked_self_attention(q, q, q, m, backend=cfg.attention_backend)

    def sin(acc, h):
        return torch.square(torch.sin(h + acc.to(h.dtype)))

    def ffn_linear(acc, h, w1, w2):
        return ((h + acc.to(h.dtype)) @ w1) @ w2

    def named(products, names):
        return F.forward_flops(p for p in products if p.name in names)

    for tag, t in (("hi", coarse), ("lo", coarse // 2)):
        block_products = F.transformer_block_products(cfg, b, t, ch)
        ones = torch.ones((b, t), device=dev)
        out[f"tblock_{tag}"] = (block_fn(tblock, False), (randn(b, t, ch, dtype=carry), ones),
                                F.forward_flops(block_products))
        out[f"resnet_{tag}"] = (block_fn(resnet, True), (randn(b, t, ch, dtype=carry), ones),
                                F.forward_flops(F.resnet_block_products(cfg, b, t, ch, ch)))
        out[f"ffn_{tag}"] = (ffn, (randn(b, t, ch, dtype=dt),), named(block_products, ("ff.proj", "ff.out")))
        out[f"attn_{tag}"] = (attn, (randn(b, nh, t, hd, dtype=dt), ones),
                              named(block_products, ("attention.qk", "attention.pv")))
        if tag == "hi":
            out["sin_hi"] = (sin, (randn(b, t, 4 * ch, dtype=dt),), 0.0)
            out["ffn_linear_hi"] = (ffn_linear, (randn(b, t, ch, dtype=dt), w1, w2),
                                    named(block_products, ("ff.proj", "ff.out")))
    return out


def main(argv=None) -> int:
    from matcha_tpu_torch import bench
    from matcha_tpu_torch.inference import resolve_device
    from matcha_tpu_torch.utils.flops import synthesis_flops
    from matcha_tpu_torch.utils.probe import inner_repeat

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--tx", type=int, default=256)
    p.add_argument("--fine", type=int, default=1024)  # fine mel frames
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--attention_backend", default="auto")
    p.add_argument("--components", default=DEFAULT_COMPONENTS, help=f"any of {','.join(ALL_COMPONENTS)}, or 'all'")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--tiny", action="store_true", help="tiny widths, for the tests")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    want = list(ALL_COMPONENTS) if args.components == "all" else [
        c.strip() for c in args.components.split(",") if c.strip()]
    unknown = sorted(set(want) - set(ALL_COMPONENTS))
    if unknown:
        raise ValueError(f"unknown components {unknown}; choose from {ALL_COMPONENTS}")

    cfg, vcfg = bench.configs(args.compute_dtype, args.tiny)
    cfg = dataclasses.replace(cfg, attention_backend=args.attention_backend)
    synth = bench.build_synthesizer(cfg, vcfg, device, args.tiny)
    b, tx, fine = args.batch, args.tx, args.fine
    request_flops = synthesis_flops(cfg, vcfg, b, tx, fine)
    out = {"batch": b, "tx": tx, "fine": fine, "coarse": fine // 2, "compute_dtype": args.compute_dtype,
           "attention_backend": args.attention_backend, "durations": bench.DURATIONS,
           "method": f"inner-repeat k={args.k}: one CUDA-graph replay of the k-call chain" if on_card
           else f"inner-repeat k={args.k}, eager on the CPU (not a device time)",
           "synthesis_flops": request_flops, "device": bench.device_info(device)}
    with torch.inference_mode():
        probes = components(synth, cfg, vcfg, b, tx, fine)
        for name in want:
            fn, extra, flops = probes[name]

            def body(acc, *a, fn=fn):
                return consume(fn(acc, *a))

            scalar = float(body(torch.zeros((), device=device), *extra))
            r = inner_repeat(body, *extra, k=args.k, reps=args.reps)
            entry = {"scalar": scalar, "flops": flops, "flops_share": flops / request_flops}
            if on_card:
                entry.update(device_ms=r["device_ms"], fixed_ms=r["fixed_ms"],
                             tflop_per_s=flops / (r["device_ms"] * 1e-3) / 1e12 if r["device_ms"] > 0 else None)
            else:
                entry.update(device_ms=None, fixed_ms=None, tflop_per_s=None, cpu_ms=r["device_ms"])
            out[name] = entry
            print(f"# {name}: {entry}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
