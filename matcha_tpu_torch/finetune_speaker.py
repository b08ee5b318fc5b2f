"""Single-speaker fine-tuning: ``python -m matcha_tpu_torch.finetune_speaker``.

CLI:  python -m matcha_tpu_torch.finetune_speaker --target_speaker N \
          ckpt_path=<checkpoint dir> [overrides...] [--device cpu]

The port's counterpart of ``matcha_tpu/finetune_speaker.py``.  Everything
is frozen except the two speaker-embedding tables: the trainable mask
(True only on ``speaker_embeddings_enc.weight`` and
``speaker_embeddings_dur.weight``) zeroes every other update after AdamW,
while the global-norm clip still runs over all gradients, frozen ones
included, as the optax chain does.  The corpus is filtered to the target
speaker, so only that speaker's rows get gradients; embeddings are in the
no-decay group, so every other row keeps its value exactly.  The full
training step runs, on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.train.__main__ import build_model_config, build_trainer
from matcha_tpu_torch.train.checkpoint import SPEAKER_TABLES
from matcha_tpu_torch.utils.configs import compose
from matcha_tpu_torch.weights import matcha_param_table


def trainable_mask_for_speaker(cfg: MatchaConfig) -> dict[str, bool]:
    """Parameter name → True only for the two speaker-embedding tables."""
    tables = {f"{t}.weight" for t in SPEAKER_TABLES}
    return {name: name in tables for name, _, _ in matcha_param_table(cfg)}


def finetune(cfg: dict, target_speaker: int):
    """Fine-tune ``target_speaker``'s rows from the composed config's
    ``ckpt_path``; returns the final TrainState (the trainer also writes
    its checkpoints under ``paths.output_dir``)."""
    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path:
        raise SystemExit("finetune_speaker requires ckpt_path=<checkpoint dir>")
    trainer = build_trainer(cfg, trainable_mask=trainable_mask_for_speaker(build_model_config(cfg)))
    try:
        train_ds = trainer.train_ds.filter_speaker(target_speaker)
        valid_ds = (trainer.valid_ds.filter_speaker(target_speaker)
                    if trainer.valid_ds is not None else None)
        if len(train_ds) == 0:
            raise SystemExit(f"No utterances for speaker {target_speaker}")
        trainer.set_datasets(train_ds, valid_ds)
        return trainer.fit(resume_from=ckpt_path)
    finally:
        trainer.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fine-tune one speaker's embeddings")
    parser.add_argument(
        "--config",
        default=str(Path(__file__).resolve().parent.parent / "configs" / "train.yaml"),
    )
    parser.add_argument("--target_speaker", type=int, required=True)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = compose(args.config, args.overrides)
    if args.device is not None:
        cfg["device"] = args.device
    return finetune(cfg, args.target_speaker)


if __name__ == "__main__":
    main()
