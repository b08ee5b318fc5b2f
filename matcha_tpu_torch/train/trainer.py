"""Training loop: epochs over bucketed batches, validation, checkpoints.

Counterpart of ``matcha_tpu/train/trainer.py`` on one device:

  * the sampler re-seeded per epoch (fresh jittered packing, stable count)
  * validation every N epochs through the same loss pipeline
  * checkpoints every N epochs, keep-last-K, with the optimizer state
  * metrics to JSONL (always) and TensorBoard (when importable)
  * a prefetch thread collates the next batches and copies them to the
    card from pinned memory with ``non_blocking=True`` while steps run

``TrainerConfig.use_mesh`` is accepted and ignored (one device);
``tensor_parallel > 1`` raises.  Data parallelism is later work.
"""

from __future__ import annotations

import json
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from matcha_tpu_torch.data.datamodule import TextMelDataModule
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.models.config import MatchaConfig
from matcha_tpu_torch.train.checkpoint import load_train_state, save_checkpoint
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainState, TrainStep, step_seed


@dataclass
class TrainerConfig:
    output_dir: str = "logs/train/run"
    max_epochs: int = -1
    check_val_every_n_epoch: int = 5
    checkpoint_every_n_epochs: int = 5
    keep_last_checkpoints: int = 10
    log_every_n_steps: int = 10
    seed: int = 1234
    use_mesh: bool = True      # accepted for config compatibility; one device
    tensor_parallel: int = 1


class MetricLogger:
    """JSONL metrics sink, plus TensorBoard when it can be imported."""

    def __init__(self, out_dir: Path):
        out_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(out_dir / "metrics.jsonl", "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(log_dir=str(out_dir / "tb"))

    def log(self, step: int, metrics: dict):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self.tb.add_scalar(k, v, step)

    def close(self):
        if not self.jsonl.closed:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
            self.tb = None


class Trainer:
    def __init__(
        self,
        model_cfg: MatchaConfig,
        opt_cfg: OptimizerConfig,
        trainer_cfg: TrainerConfig,
        train_dataset: TextMelDataset,
        valid_dataset: TextMelDataset | None = None,
        max_frames_per_batch: int = 32000,
        len_bucket: int = 32,
        text_bucket: int = 32,
        trainable_mask: dict[str, bool] | None = None,
        device=None,
    ):
        if trainer_cfg.tensor_parallel > 1:
            raise NotImplementedError("tensor parallelism is not ported: the port trains on one device")
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.trainable_mask = trainable_mask
        self.steps = TrainStep(model_cfg, opt_cfg, device, trainable_mask)
        self.device = self.steps.device
        self.train_step = self.steps.train_step
        self.eval_step = self.steps.eval_step
        self.dm = TextMelDataModule(
            train_dataset, valid_dataset,
            max_frames_per_batch=max_frames_per_batch, len_bucket=len_bucket,
            text_bucket=text_bucket, seed=trainer_cfg.seed,
        )
        self.out_dir = Path(trainer_cfg.output_dir)
        self.logger = MetricLogger(self.out_dir)

    def init_state(self, resume_from: str | None = None) -> TrainState:
        """Fresh (random weights from the run's seed) or resumed state.

        Learning rate and weight decay always come from this run's config.
        A fine-tune (``trainable_mask`` set) loads the parameters only and
        starts its optimizer fresh, as the JAX trainer does.
        """
        if not resume_from:
            return self.steps.init_state(generator=torch.Generator().manual_seed(self.cfg.seed))
        fine_tune = self.trainable_mask is not None
        params, opt_state, step, _, ckpt_cfg = load_train_state(
            resume_from, self.device, with_optimizer=not fine_tune)
        if ckpt_cfg.n_spks != self.model_cfg.n_spks:
            raise NotImplementedError(
                f"checkpoint has {ckpt_cfg.n_spks} speakers, config {self.model_cfg.n_spks}: "
                "speaker-table expansion is not ported yet"
            )
        if fine_tune:
            return TrainState(params, self.steps.opt.init(params), 0)
        return TrainState(params, opt_state, step)

    def _prefetch(self, batches, depth: int = 2):
        """Collate ``depth`` batches ahead in a thread and copy each to the
        device (pinned host memory, ``non_blocking=True`` on the card).
        Worker exceptions re-raise in the consumer."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()
        on_card = self.device.type == "cuda"

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if on_card:
                        b = Batch(*(t.pin_memory() for t in b)).to(self.device, non_blocking=True)
                    if not put(b):
                        return  # the consumer stopped early
                put(done)
            except BaseException as exc:  # re-raised in the training loop
                put(exc)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=30)

    def fit(self, resume_from: str | None = None, max_steps: int | None = None) -> TrainState:
        state = self.init_state(resume_from)
        n_params = sum(p.numel() for p in state.params.values())
        self.logger.log(state.step, {"model/params_total": n_params})
        epoch = 0
        done = False
        last_saved = None
        while not done and (self.cfg.max_epochs < 0 or epoch < self.cfg.max_epochs):
            t_epoch = time.time()
            losses = []
            for batch in self._prefetch(self.dm.train_batches(epoch)):
                state, metrics = self.train_step(state, batch, self.cfg.seed)
                losses.append(metrics["loss"])
                if state.step % self.cfg.log_every_n_steps == 0:
                    self.logger.log(state.step, metrics)
                if max_steps is not None and state.step >= max_steps:
                    done = True
                    break
            self.logger.log(state.step, {
                "loss/train_epoch": float(torch.stack(losses).mean()) if losses else 0.0,
                "epoch": epoch,
                "epoch_seconds": time.time() - t_epoch,
            })
            if self.dm.has_valid and (epoch + 1) % self.cfg.check_val_every_n_epoch == 0:
                self.validate(state, epoch)
            if (epoch + 1) % self.cfg.checkpoint_every_n_epochs == 0 or done:
                self.save(state, epoch)
                last_saved = epoch
            epoch += 1
        if epoch > 0 and last_saved != epoch - 1:
            self.save(state, epoch - 1)
        return state

    def validate(self, state: TrainState, epoch: int):
        vals = []
        for i, batch in enumerate(self._prefetch(self.dm.valid_batches())):
            # a seed per batch, so CFM's (t, noise) differ across batches
            m = self.eval_step(state.params, batch, step_seed(self.cfg.seed, i))
            vals.append(float(m["loss"]))
        self.logger.log(state.step, {"loss/val": sum(vals) / len(vals) if vals else 0.0,
                                     "epoch": epoch})

    def save(self, state: TrainState, epoch: int):
        path = self.out_dir / "checkpoints" / f"epoch_{epoch:05d}"
        save_checkpoint(path, state.params, state.opt_state, state.step, epoch, self.model_cfg)
        self._prune_checkpoints()

    def _prune_checkpoints(self):
        ckpt_dir = self.out_dir / "checkpoints"
        if not ckpt_dir.exists():
            return
        for stale in sorted(ckpt_dir.glob("epoch_*"))[: -self.cfg.keep_last_checkpoints]:
            shutil.rmtree(stale, ignore_errors=True)

    def close(self):
        """Release the metrics sinks."""
        self.logger.close()
