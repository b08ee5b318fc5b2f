"""Train the StyleEncoder against a frozen MatchaTTS checkpoint.

CLI:  python -m matcha_tpu_torch.train_style_encoder ckpt_path=<matcha ckpt> \
          [overrides...] [--max_epochs 50] [--lr 1e-4] [--device cpu]

The port's counterpart of ``matcha_tpu/train_style_encoder.py``: batches
from the corpus's bucketed sampler, one optimizer step per batch, the
epoch's mean loss appended to ``metrics.jsonl`` and the StyleEncoder's
parameters written to ``style_params.pkl`` after every epoch, in the flax
layout the JAX tool writes (``weights.style_params_to_jax``), so either
package's ``add_speaker`` reads it.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import pickle
import time
from pathlib import Path

import torch

from matcha_tpu_torch.checkpoint import load_checkpoint
from matcha_tpu_torch.data.collate import epoch_batches
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.data.sampler import BucketedBatchSampler
from matcha_tpu_torch.inference import resolve_device, strict_fp32
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.models.style_encoder import StyleEncoder, init_style_params, style_encoder_loss
from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig, OptState
from matcha_tpu_torch.utils.configs import compose
from matcha_tpu_torch.weights import params_from_jax, style_params_to_jax


def style_optimizer(style: StyleEncoder, lr: float) -> AdamW:
    """The JAX tool's ``optax.chain(clip_by_global_norm(4.0), optax.adamw(lr))``
    as the port's ``AdamW``, built with optax's adamw defaults (b1 0.9,
    b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter: an all-True
    decay mask) and no skipping of non-finite updates.  These are not the
    model's ``OptimizerConfig`` defaults."""
    cfg = OptimizerConfig(lr=lr, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8, grad_clip=4.0,
                          skip_nonfinite_updates=False)
    return AdamW(cfg, decay={n: True for n, _ in style.named_parameters()})


def style_train_step(style: StyleEncoder, model: MatchaTTS, opt: AdamW, opt_state: OptState, batch):
    """One update of ``style`` in place; returns (loss, metrics), device scalars."""
    loss, metrics = style_encoder_loss(style, model, batch)
    params = dict(style.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    opt.update(params, dict(zip(params, grads)), opt_state)
    return loss.detach(), metrics


def load_frozen_model(ckpt_path: str, device) -> MatchaTTS:
    """A checkpoint's MatchaTTS on ``device``, in eval mode, no gradients."""
    tree, cfg = load_checkpoint(ckpt_path)
    model = MatchaTTS(cfg)
    model.load_state_dict(params_from_jax(tree["params"], cfg))
    return model.to(device).eval().requires_grad_(False)


def train(cfg: dict, max_epochs: int = 50, lr: float = 1e-4, device=None) -> StyleEncoder:
    """Train a StyleEncoder against the composed config's ``ckpt_path``;
    returns it (``metrics.jsonl`` and ``style_params.pkl`` land under
    ``paths.output_dir``)."""
    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path:
        raise SystemExit("train_style_encoder requires ckpt_path=<matcha ckpt>")
    device = resolve_device(device)
    strict_fp32(device)
    model = load_frozen_model(ckpt_path, device)

    data = cfg["data"]
    ds = TextMelDataset(data["train_filelist_path"], data["mel_dir"])
    sampler = BucketedBatchSampler(
        [ds.mel_length(i) for i in range(len(ds))],
        max_frames_per_batch=int(data.get("max_frames_per_batch", 32000)),
        len_bucket=int(data.get("len_bucket", 32)),
        seed=int(cfg.get("seed", 1234)),
    )

    style = StyleEncoder(model.cfg.n_feats, model.cfg.spk_emb_dim)
    style.load_state_dict(init_style_params(model.cfg, torch.Generator().manual_seed(0)))
    style.to(device)
    opt = style_optimizer(style, lr)
    opt_state = opt.init(dict(style.named_parameters()))

    out_dir = Path(cfg.get("paths", {}).get("output_dir", "logs/style_encoder"))
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "metrics.jsonl", "a") as log:
        for epoch in range(max_epochs):
            losses = []
            for batch in epoch_batches(ds, sampler, epoch, int(data.get("text_bucket", 32))):
                loss, _ = style_train_step(style, model, opt, opt_state, batch.to(device))
                losses.append(loss)
            rec = {"epoch": epoch, "loss": float(torch.stack(losses).mean()), "time": time.time()}
            log.write(json.dumps(rec) + "\n")
            log.flush()
            print(f"epoch {epoch}: loss {rec['loss']:.4f}")
            with open(out_dir / "style_params.pkl", "wb") as f:
                pickle.dump(style_params_to_jax(style.state_dict()), f)
    return style


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--config",
        default=str(Path(__file__).resolve().parent.parent / "configs" / "train.yaml"),
    )
    parser.add_argument("--max_epochs", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    return train(compose(args.config, args.overrides), args.max_epochs, args.lr, args.device)


if __name__ == "__main__":
    main()
