"""Training loop: epochs over bucketed batches, validation, checkpoints.

It trains either model ``train/step.py`` builds: MatchaTTS from a
``MatchaConfig``, or F5-TTS's DiT from a ``DiTConfig`` (one device only;
its checkpoints hold no speaker tables).  Counterpart of
``matcha_tpu/train/trainer.py``:

  * the sampler re-seeded per epoch (fresh jittered packing, stable count)
  * validation every N epochs through the same loss pipeline
  * checkpoints every N epochs, keep-last-K, with the optimizer state
  * metrics to JSONL (always) and TensorBoard (when importable)
  * a prefetch thread collates the next batches and copies them to the
    card from pinned memory with ``non_blocking=True`` while steps run; on
    the card the mels come from the native loader (``data/native_loader.py``,
    built at the trainer's start: a build or load failure raises there),
    filled straight into pinned tensors; on the CPU from numpy

Data parallelism (``TrainerConfig.use_mesh``, the default): when a process
group is running, or ``WORLD_SIZE`` > 1 asks for one (``torchrun``; the
trainer then starts it and ``close`` ends it), every batch size is a
multiple of the group's size, each rank collates and trains on its block
of rows (MAS runs per rank on them, as the JAX package's shard_map does),
the step sums losses and gradients over the group (``train/step.py``),
validation losses are summed likewise, and only rank 0 writes checkpoints
and metrics; every rank reads a checkpoint on resume.  One process with no
group trains alone.

Tensor parallelism (``TrainerConfig.tensor_parallel = k > 1``, the JAX
trainer's ``tensor_parallel``): the ranks of the group (started from
``WORLD_SIZE`` as above; one must be running) form a (world/k, k) grid
(``parallel/sharding.py::make_mesh_2d``); batch sizes are multiples of the
data-parallel size world/k, each data index's ranks train on one block of
rows with the model's FFN and attention pairs split over them, and rank 0
gathers whole tensors into its checkpoints, which load at any
``tensor_parallel``.
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

from matcha_tpu_torch.checkpoint import load_checkpoint
from matcha_tpu_torch.data import native_loader
from matcha_tpu_torch.data.datamodule import TextMelDataModule
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.inference import resolve_device
from matcha_tpu_torch.models.config import DiTConfig, MatchaConfig
from matcha_tpu_torch.parallel import mesh, sharding
from matcha_tpu_torch.train.checkpoint import (
    expand_speaker_tables,
    save_checkpoint,
    train_state_from_tree,
)
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainState, TrainStep, step_seed
from matcha_tpu_torch.utils.profiling import annotate


@dataclass
class TrainerConfig:
    output_dir: str = "logs/train/run"
    max_epochs: int = -1
    check_val_every_n_epoch: int = 5
    checkpoint_every_n_epochs: int = 5
    keep_last_checkpoints: int = 10
    log_every_n_steps: int = 10
    seed: int = 1234
    use_mesh: bool = True      # data-parallel over the process group, if there is one
    tensor_parallel: int = 1
    # the store of the group the trainer starts when WORLD_SIZE > 1 (nccl on
    # the card, gloo on the CPU); torchrun's MASTER_ADDR/PORT by default
    dist_init_method: str = "env://"


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


class NullLogger:
    """The metrics sink of a rank other than 0: drops everything."""

    def log(self, step: int, metrics: dict):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(
        self,
        model_cfg: MatchaConfig | DiTConfig,
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
        tp = trainer_cfg.tensor_parallel
        if tp > 1 and not trainer_cfg.use_mesh:
            raise ValueError("tensor_parallel > 1 needs use_mesh")
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.trainable_mask = trainable_mask
        device = resolve_device(device)
        self._owns_group = False
        if trainer_cfg.use_mesh and not mesh.active() and mesh.env_world_size() > 1:
            mesh.init_data_parallel(device, init_method=trainer_cfg.dist_init_method)
            self._owns_group = True
        self.data_parallel = trainer_cfg.use_mesh and mesh.active()
        self.rank, self.world = (mesh.rank(), mesh.world()) if self.data_parallel else (0, 1)
        self.mesh2d = None
        if tp > 1:
            if not self.data_parallel:
                raise RuntimeError(f"tensor_parallel={tp} needs a process group of a multiple of {tp} "
                                   "ranks (torchrun --nproc_per_node ...)")
            try:
                self.mesh2d = sharding.make_mesh_2d(self.world, tp)
            except ValueError:  # tp does not divide the world: end a group this trainer started
                if self._owns_group:
                    mesh.destroy()
                raise
        self.steps = TrainStep(model_cfg, opt_cfg, device, trainable_mask, self.data_parallel,
                               mesh2d=self.mesh2d)
        self.device = self.steps.device
        self.train_step = self.steps.train_step
        self.eval_step = self.steps.eval_step
        use_native = self.device.type == "cuda"
        if use_native:
            native_loader.load_library()
        self.dm = TextMelDataModule(
            train_dataset, valid_dataset,
            max_frames_per_batch=max_frames_per_batch, len_bucket=len_bucket,
            text_bucket=text_bucket, batch_multiple=self.steps.data_size, seed=trainer_cfg.seed,
            use_native=use_native,
        )
        self.out_dir = Path(trainer_cfg.output_dir)
        self.logger = MetricLogger(self.out_dir) if self.rank == 0 else NullLogger()

    def set_datasets(self, train_dataset: TextMelDataset, valid_dataset: TextMelDataset | None = None):
        """Swap datasets (e.g. speaker-filtered) and rebuild the samplers."""
        self.dm = self.dm.replace_datasets(train_dataset, valid_dataset)

    @property
    def train_ds(self) -> TextMelDataset:
        return self.dm.train_ds

    @property
    def valid_ds(self) -> TextMelDataset | None:
        return self.dm.valid_ds

    @property
    def sampler(self):
        return self.dm.train_sampler

    @property
    def valid_sampler(self):
        return self.dm.valid_sampler

    @property
    def _shard(self) -> tuple[int, int] | None:
        """This rank's block of rows (data index, data-parallel size) under
        data parallelism."""
        return (self.steps.data_index, self.steps.data_size) if self.data_parallel else None

    def init_state(self, resume_from: str | None = None) -> TrainState:
        """Fresh (random weights from the run's seed) or resumed state.

        Learning rate and weight decay always come from this run's config.
        A full resume from a checkpoint with fewer speakers than the config
        zero-extends both speaker tables and their Adam moment rows (the JAX
        trainer's rule); one with more raises.  A fine-tune
        (``trainable_mask`` set) loads the parameters only and starts its
        optimizer fresh, as the JAX trainer does, and needs the
        checkpoint's speaker count.
        """
        state = self._load_state(resume_from)
        if self.mesh2d is not None:  # each block from data index 0's
            mesh.broadcast_state(state.params, src=self.mesh2d.dp_root, group=self.mesh2d.dp_group)
        elif self.data_parallel:  # every rank starts from rank 0's parameters
            mesh.broadcast_state(state.params)
        return state

    def _load_state(self, resume_from: str | None) -> TrainState:
        if not resume_from:
            return self.steps.init_state(generator=torch.Generator().manual_seed(self.cfg.seed))
        fine_tune = self.trainable_mask is not None
        tree, ckpt_cfg = load_checkpoint(resume_from)
        if type(ckpt_cfg) is not type(self.model_cfg):
            raise ValueError(f"{resume_from} holds a {type(ckpt_cfg).__name__}, "
                             f"this run trains a {type(self.model_cfg).__name__}")
        if isinstance(ckpt_cfg, DiTConfig):
            return self._state_from_tree(tree, ckpt_cfg, fine_tune)
        want = self.model_cfg.n_spks
        if fine_tune and ckpt_cfg.n_spks != want:
            raise ValueError(
                f"checkpoint has {ckpt_cfg.n_spks} speakers but the config asks for {want}: "
                f"a fine-tune needs the checkpoint's count (override data.n_spks={ckpt_cfg.n_spks})"
            )
        if ckpt_cfg.n_spks > want:
            raise ValueError(
                f"checkpoint has {ckpt_cfg.n_spks} speakers but config asks for {want}; "
                "shrinking is not supported"
            )
        if ckpt_cfg.n_spks < want:
            print(f"expanded speaker tables {ckpt_cfg.n_spks} → {want} on resume")
            tree, ckpt_cfg = expand_speaker_tables(tree, ckpt_cfg, want)
        return self._state_from_tree(tree, ckpt_cfg, fine_tune)

    def _state_from_tree(self, tree, ckpt_cfg, fine_tune: bool) -> TrainState:
        params, opt_state, step, _ = train_state_from_tree(
            tree, ckpt_cfg, self.device, with_optimizer=not fine_tune)
        params = {n: p.detach().requires_grad_(True) for n, p in self.steps.local_state(params).items()}
        if fine_tune:
            return TrainState(params, self.steps.opt.init(params), 0)
        return TrainState(params, self.steps.local_opt_state(opt_state), step)

    def _prefetch(self, batches, depth: int = 2):
        """Collate ``depth`` batches ahead in a thread and copy each to the
        device (pinned host memory, ``non_blocking=True`` on the card; a
        tensor the native loader filled is pinned already).  Worker
        exceptions re-raise in the consumer."""
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
                        b = Batch(*(t if t.is_pinned() else t.pin_memory() for t in b))
                        b = b.to(self.device, non_blocking=True)
                    if not put(b):
                        return  # the consumer stopped early
                put(done)
            except BaseException as exc:  # re-raised in the training loop
                put(exc)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                with annotate("matcha/loader.wait"):
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
        n_params = sum(p.numel() for p in self.steps.model.state_dict().values())
        self.logger.log(state.step, {"model/params_total": n_params})
        epoch = 0
        done = False
        last_saved = None
        while not done and (self.cfg.max_epochs < 0 or epoch < self.cfg.max_epochs):
            t_epoch = time.time()
            losses = []
            for batch in self._prefetch(self.dm.train_batches(epoch, self._shard)):
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
        for i, batch in enumerate(self._prefetch(self.dm.valid_batches(self._shard))):
            # a seed per batch, so CFM's (t, noise) differ across batches
            m = self.eval_step(state.params, batch, step_seed(self.cfg.seed, i))
            vals.append(float(m["loss"]))
        self.logger.log(state.step, {"loss/val": sum(vals) / len(vals) if vals else 0.0,
                                     "epoch": epoch})

    def save(self, state: TrainState, epoch: int):
        """Rank 0 writes whole tensors (gathered from every tensor-parallel
        rank's blocks); the others wait until it has."""
        params, opt_state = self.steps.whole_state(state)
        if self.rank == 0:
            path = self.out_dir / "checkpoints" / f"epoch_{epoch:05d}"
            save_checkpoint(path, params, opt_state, state.step, epoch, self.model_cfg,
                            optimizer=self.steps.opt)
            self._prune_checkpoints()
        if self.data_parallel:
            mesh.barrier()

    def _prune_checkpoints(self):
        ckpt_dir = self.out_dir / "checkpoints"
        if not ckpt_dir.exists():
            return
        for stale in sorted(ckpt_dir.glob("epoch_*"))[: -self.cfg.keep_last_checkpoints]:
            shutil.rmtree(stale, ignore_errors=True)

    def close(self):
        """Release the metrics sinks, and the process group if this trainer
        started it."""
        self.logger.close()
        if self._owns_group:
            mesh.destroy()
            self._owns_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
