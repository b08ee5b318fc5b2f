"""Training entry point of the port: ``python -m matcha_tpu_torch.train [overrides...]``.

The JAX package's config surface (reference Hydra CLI, matcha/train.py):

    python -m matcha_tpu_torch.train trainer.max_epochs=100 experiment=v19
    python -m matcha_tpu_torch.train ckpt_path=logs/.../epoch_00004

through the light YAML composer (configs/train.yaml + configs/experiment/*),
which needs PyYAML.  Trains on the card; ``device=cpu`` runs the plain
versions on the CPU.  Data-parallel over N cards of one host:

    torchrun --nproc_per_node=N -m matcha_tpu_torch.train [overrides...]

each rank on ``cuda:$LOCAL_RANK`` (``trainer.use_mesh=false`` trains each
process alone).  Tensor-parallel over a (data, model) grid of ranks:

    torchrun --nproc_per_node=2 -m matcha_tpu_torch.train trainer.tensor_parallel=2 \
        experiment=v20-production

(``parallel/sharding.py``).  Rank 0 prints the composed config as a tree
(``utils/print_config.py``), as the JAX entry point does.

The override ``arch=f5tts_dit`` trains F5-TTS v1 Base's DiT instead
(``models/dit.py``; one device, no data or tensor parallelism), with F5's
recipe as the preset under the command line's own overrides
(``DIT_PRESET``: AdamW at 7.5e-5, b2 0.999, weight decay 0.01 on every
leaf, clip 1.0, 38,400 frames a batch).  Its widths are ``DiTConfig``'s
published ones; ``dit.<field>=...`` overrides one, and the ``model:``
section is not read:

    python -m matcha_tpu_torch.train arch=f5tts_dit data.train_filelist_path=... \
        data.mel_dir=... [dit.depth=...]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.models.config import DIT_ARCH, DataStatistics, DiTConfig, MatchaConfig
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig
from matcha_tpu_torch.utils.configs import compose
from matcha_tpu_torch.utils.print_config import print_config


# the overrides ``arch=f5tts_dit`` puts under the command line's (F5TTS_v1_Base.yaml's recipe)
DIT_PRESET = ("optimizer.lr=7.5e-5", "optimizer.weight_decay=0.01", "optimizer.b2=0.999",
              "optimizer.grad_clip=1.0", "data.max_frames_per_batch=38400", "trainer.use_mesh=false")


def build_dit_config(cfg: dict) -> DiTConfig:
    """The ``dit:`` section → DiTConfig (published widths where unset; the
    mel width from ``data.n_feats``); unknown keys raise."""
    d = dict(cfg.get("dit", {}))
    unknown = set(d) - {f.name for f in dataclasses.fields(DiTConfig)}
    if unknown:
        raise ValueError(f"unknown dit config keys: {sorted(unknown)}")
    d.setdefault("n_feats", int(cfg.get("data", {}).get("n_feats", DiTConfig.n_feats)))
    return DiTConfig.from_dict(d)


def build_model_config(cfg: dict) -> MatchaConfig | DiTConfig:
    """YAML ``model:`` section → MatchaConfig, including nested sections;
    with ``arch: f5tts_dit``, the ``dit:`` section → DiTConfig.

    Nested ``encoder`` / ``duration_predictor`` / ``decoder`` / ``cfm``
    overlays merge field-by-field onto the defaults (the reference's
    experiment overlays override these freely, e.g. v19's decoder widening);
    unknown keys raise instead of silently vanishing.
    """
    if cfg.get("arch") == DIT_ARCH:
        return build_dit_config(cfg)
    m = dict(cfg.get("model", {}))
    stats = cfg.get("data", {}).get("data_statistics", {})
    base = MatchaConfig()
    sub_types = ("encoder", "duration_predictor", "decoder", "cfm")
    top_fields = {f.name for f in dataclasses.fields(base)}
    kw = {}
    for k, v in m.items():
        if k in sub_types and isinstance(v, dict):
            cur = getattr(base, k)
            valid = {f.name for f in dataclasses.fields(cur)}
            unknown = set(v) - valid
            if unknown:
                raise ValueError(f"unknown model.{k} config keys: {sorted(unknown)}")
            kw[k] = dataclasses.replace(cur, **v)
        elif k == "data_statistics" and isinstance(v, dict):
            # coerce like the nested sections: a raw dict would only fail at
            # use time (stats.mel_mean attribute access)
            kw[k] = DataStatistics(
                mel_mean=float(v["mel_mean"]), mel_std=float(v["mel_std"])
            )
        elif k in top_fields:
            kw[k] = v
        else:
            raise ValueError(f"unknown model config key: {k!r}")
    if "data_statistics" not in kw and stats:
        kw["data_statistics"] = DataStatistics(
            mel_mean=float(stats.get("mel_mean", -4.684777)),
            mel_std=float(stats.get("mel_std", 6.512275)),
        )
    out = dataclasses.replace(base, **kw)
    # keep the encoder's mel width in lockstep with the model-level n_feats
    if out.encoder.n_feats != out.n_feats:
        out = dataclasses.replace(
            out, encoder=dataclasses.replace(out.encoder, n_feats=out.n_feats)
        )
    return dataclasses.replace(
        out,
        n_spks=int(out.n_spks),
        decoder=dataclasses.replace(
            out.decoder, channels=tuple(out.decoder.channels)
        ),
    )


def build_trainer(cfg: dict, trainable_mask=None) -> Trainer:
    data = cfg["data"]
    tr = cfg.get("trainer", {})
    opt = cfg.get("optimizer", {})

    train_ds = TextMelDataset(data["train_filelist_path"], data["mel_dir"])
    valid_path = data.get("valid_filelist_path")
    valid_ds = (
        TextMelDataset(valid_path, data["mel_dir"])
        if valid_path and Path(valid_path).exists()
        else None
    )

    return Trainer(
        model_cfg=build_model_config(cfg),
        opt_cfg=OptimizerConfig(
            lr=float(opt.get("lr", 5e-5)),
            weight_decay=float(opt.get("weight_decay", 1e-4)),
            b1=float(opt.get("b1", 0.9)),
            b2=float(opt.get("b2", 0.99)),
            eps=float(opt.get("eps", 1e-8)),
            grad_clip=float(opt.get("grad_clip", 4.0)),
            accumulate_grad_batches=int(
                tr.get("accumulate_grad_batches", 1)
            ),
        ),
        trainer_cfg=TrainerConfig(
            output_dir=cfg.get("paths", {}).get("output_dir", "logs/train/run"),
            max_epochs=int(tr.get("max_epochs", -1)),
            check_val_every_n_epoch=int(tr.get("check_val_every_n_epoch", 5)),
            checkpoint_every_n_epochs=int(tr.get("checkpoint_every_n_epochs", 5)),
            keep_last_checkpoints=int(tr.get("keep_last_checkpoints", 10)),
            log_every_n_steps=int(tr.get("log_every_n_steps", 10)),
            seed=int(cfg.get("seed", 1234)),
            use_mesh=str(tr.get("use_mesh", True)).lower() not in ("false", "0", "no"),
            tensor_parallel=int(tr.get("tensor_parallel", 1)),
        ),
        train_dataset=train_ds,
        valid_dataset=valid_ds,
        max_frames_per_batch=int(data.get("max_frames_per_batch", 32000)),
        len_bucket=int(data.get("len_bucket", 32)),
        text_bucket=int(data.get("text_bucket", 32)),
        trainable_mask=trainable_mask,
        device=cfg.get("device") or default_device(),
    )


def default_device() -> str | None:
    """``cuda:$LOCAL_RANK`` under torchrun, else None (the card)."""
    local = os.environ.get("LOCAL_RANK")
    return f"cuda:{int(local)}" if local is not None else None


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train MatchaTTS-24k (or, with arch=f5tts_dit, F5-TTS's DiT) with PyTorch")
    parser.add_argument(
        "--config",
        default=str(
            Path(__file__).resolve().parent.parent.parent / "configs" / "train.yaml"
        ),
    )
    parser.add_argument(
        "overrides", nargs="*", help="dotted overrides, e.g. optimizer.lr=1e-4"
    )
    args = parser.parse_args(argv)

    overrides = list(args.overrides)
    if f"arch={DIT_ARCH}" in overrides:
        overrides = [*DIT_PRESET, *overrides]
    cfg = compose(args.config, overrides)
    if os.environ.get("RANK", "0") == "0":
        print_config(cfg, title="matcha_tpu_torch.train")
    trainer = build_trainer(cfg)
    try:
        trainer.fit(resume_from=cfg.get("ckpt_path"))
    except Exception:
        # persist the traceback next to the run logs before propagating
        # (reference: matcha/utils/utils.py:52-104)
        import traceback

        log_path = Path(trainer.cfg.output_dir) / "crash.log"
        log_path.parent.mkdir(parents=True, exist_ok=True)
        log_path.write_text(traceback.format_exc())
        raise
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
