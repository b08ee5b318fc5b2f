"""F5-TTS's training loop: the trainer's own epochs over the mix's corpus
(``benchmark/training.py``'s loop, window and rebuilt batches), with the
DiT built from the configuration's ``model`` and judged by the plain fp32
reference ``reference/f5tts.py``.

Judgement: the three judged batches rebuilt row by row from the corpus
files, and the reference's three steps from the same weights compared
with the program's: each step's loss, the first step's gradient as the
optimizer took it, each leaf's change after the three steps
(``training.compare``).  The reference's guidance drops of each step are
recorded beside the program's counts (``run.extra["drops"]``).
"""

from __future__ import annotations

import os
import shutil

from benchmark import training
from benchmark.harness import WORK, model_shapes, random_weights
from benchmark.reference import f5tts as ref


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The DiT's state_dict from ``seed`` on ``device``, in one draw, by the
    harness's rule (``harness.random_weights``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    return random_weights(model_shapes(ref.F5TTS, cfg["model"]), gen, device)


class Driver(training.Driver):
    def setup(self):
        import torch

        from matcha_tpu_torch.data.dataset import TextMelDataset
        from matcha_tpu_torch.models.config import DiTConfig
        from matcha_tpu_torch.train.optim import OptimizerConfig
        from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

        run, tr = self.run, self.run.cfg["training"]
        n_feats = run.cfg["model"]["n_feats"]
        self.root = training.corpus_dir(run.mix["corpus"], run.mix["base_seed"], n_feats)
        logs = WORK / "train-logs"
        shutil.rmtree(logs, ignore_errors=True)
        self.trainer = Trainer(
            DiTConfig.from_dict(run.cfg["model"]), OptimizerConfig(**tr["optimizer"]),
            TrainerConfig(output_dir=str(logs), max_epochs=-1, log_every_n_steps=tr["log_every_n_steps"],
                          seed=run.seed, use_mesh=False),
            TextMelDataset(os.path.join(self.root, "train.csv"), os.path.join(self.root, "mels"), n_feats),
            None, max_frames_per_batch=tr["max_frames_per_batch"], len_bucket=tr["len_bucket"],
            text_bucket=tr["text_bucket"], device=run.device)
        params = make_weights(run.cfg, run.seed, run.device)
        self.state = self.trainer.steps.init_state(params=params)
        del params
        self._apply_fault()
        self.params0 = {n: p.detach().cpu().clone() for n, p in self.state.params.items()}
        self.batches, self.losses = [], []
        # epoch 0: the judged steps first, then every shape it packs
        for batch in self.trainer._prefetch(self.trainer.dm.train_batches(0)):
            if len(self.batches) < training.JUDGED_STEPS:
                self.batches.append(training._cpu(batch))
            self.state, metrics = self.trainer.train_step(self.state, batch, self.trainer.cfg.seed)
            if len(self.losses) < training.JUDGED_STEPS:
                self.losses.append(float(metrics["loss"]))
                if len(self.losses) == 1:
                    b1 = self.trainer.steps.opt.cfg.b1
                    self.first_grad = {n: (m / (1 - b1)).cpu() for n, m in self.state.opt_state.mu.items()}
                if len(self.losses) == training.JUDGED_STEPS:
                    self.params3 = {n: p.detach().cpu().clone() for n, p in self.state.params.items()}
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, tracer):
        dropped = dict(self.trainer.steps.model.dropped)
        super().window(tracer)
        self.run.extra["window_drops"] = {k: v - dropped[k] for k, v in self.trainer.steps.model.dropped.items()}

    def judge(self, control: bool = False):
        run = self.run
        batches, bad_rows = self.rebuilt_batches()
        params = {k: v.cpu() for k, v in make_weights(run.cfg, run.seed, run.device).items()}
        got = ref.run_steps(run.cfg, params, batches, run.seed, run.device)
        run.extra["drops"] = [(x["drop_audio"], x["drop_text"]) for x in got["losses"]]
        readings, run.extra["worst_leaf"] = training.compare(self, got)
        limits = run.extra["limits"]
        for name, value in readings.items():
            run.checks[name] = {"value": value, "limit": limits[name]}
        run.checks["rows_rebuilt_differ"] = {"value": bad_rows, "limit": 0}
        if control:
            with ref.precision("fp8"):
                low = ref.run_steps(run.cfg, params, batches, run.seed, run.device)
            stand_in = training._Readings(low["losses"], low["first_grad"], low["params"], params)
            run.extra["control"], run.extra["control_worst_leaf"] = training.compare(stand_in, got)
