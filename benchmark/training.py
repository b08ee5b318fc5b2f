"""The training path under test, and its judgement.

Set-up writes the mix's synthetic corpus once per checkout (a cache keyed
by the corpus parameters, under ``benchmark/.work``), builds the program's
``Trainer`` over it with weights made from the seed on the device, and
drives it through epoch 0: its first three steps are the judged ones, the
rest warm every shape the sampler packs.  The window then runs epochs 1,
2, ... the way ``Trainer.fit`` does, without validation or checkpoints:
``dm.train_batches(epoch)`` through the trainer's prefetch thread and the
native loader into ``Trainer.train_step``, logging every
``log_every_n_steps``.

Judgement (``reference/train.py``): the three judged batches are rebuilt
row by row from the corpus files (each row found by its ids; its mels,
lengths, speaker and padding checked against what the program fed), and
the plain fp32 reference takes the same three steps from the same
weights.  Compared: each step's loss, the first step's gradient as the
optimizer took it (Adam's first moment after one step over 1 − b1), leaf
by leaf, and each leaf's change after the three steps.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import time

import numpy as np

from benchmark import workload_gen
from benchmark.harness import WORK, Run, make_weights

JUDGED_STEPS = 3


def corpus_dir(spec: dict, base_seed: int, n_feats: int) -> str:
    """The corpus's directory, written on first use: ``train.csv`` and
    channel-major coarse and fine ``.npy`` mels (normal values, the coarse
    the mean of each pair of fine frames)."""
    key = hashlib.sha256(json.dumps([spec, base_seed, n_feats], sort_keys=True).encode()).hexdigest()[:12]
    root = WORK / f"corpus-{key}"
    if (root / "train.csv").exists():
        return str(root)
    tmp = WORK / f"corpus-{key}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "mels" / "u").mkdir(parents=True)
    rows = []
    for k, utt in enumerate(workload_gen.corpus(spec, base_seed)):
        rng = np.random.default_rng(utt["seed"])
        fine = rng.standard_normal((n_feats, 2 * utt["frames"]), dtype=np.float32)
        np.save(tmp / "mels" / "u" / f"{k:05d}.npy", 0.5 * (fine[:, ::2] + fine[:, 1::2]))
        np.save(tmp / "mels" / "u" / f"{k:05d}.fine.npy", fine)
        ids = " ".join(map(str, rng.integers(1, workload_gen.VOCAB, utt["n_ids"])))
        rows.append(f"u/{k:05d}|{utt['speaker']}|en-us|utterance {k}|{ids}")
    (tmp / "mels" / "metadata.json").write_text(json.dumps({"n_mels": n_feats}))
    (tmp / "train.csv").write_text("\n".join(rows) + "\n")
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    os.sync()  # the corpus's writeback in set-up, not in the window
    return str(root)


def _cpu(batch) -> dict:
    return {k: None if v is None else v.detach().cpu().clone() for k, v in batch._asdict().items()}


class Driver:
    def __init__(self, run: Run, fault=None):
        self.run = run
        self.fault = fault  # tests: "unchanged" or "half_batch"

    def setup(self):
        import torch

        from matcha_tpu_torch.data.dataset import TextMelDataset
        from matcha_tpu_torch.models.config import MatchaConfig
        from matcha_tpu_torch.train.optim import OptimizerConfig
        from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

        run, tr = self.run, self.run.cfg["training"]
        n_feats = run.cfg["model"]["n_feats"]
        self.root = corpus_dir(run.mix["corpus"], run.mix["base_seed"], n_feats)
        logs = WORK / "train-logs"
        shutil.rmtree(logs, ignore_errors=True)
        self.trainer = Trainer(
            MatchaConfig.from_dict(run.cfg["model"]), OptimizerConfig(**tr["optimizer"]),
            TrainerConfig(output_dir=str(logs), max_epochs=-1, log_every_n_steps=tr["log_every_n_steps"],
                          seed=run.seed, use_mesh=False),
            TextMelDataset(os.path.join(self.root, "train.csv"), os.path.join(self.root, "mels"), n_feats),
            None, max_frames_per_batch=tr["max_frames_per_batch"], len_bucket=tr["len_bucket"],
            text_bucket=tr["text_bucket"], device=run.device)
        params, _ = make_weights(run.cfg, run.seed, run.device, vocoder=False)
        self.state = self.trainer.steps.init_state(params=params)
        del params
        self._apply_fault()
        self.params0 = {n: p.detach().cpu().clone() for n, p in self.state.params.items()}
        self.batches, self.losses = [], []
        for batch in self.trainer._prefetch(self.trainer.dm.train_batches(0)):
            if len(self.batches) < JUDGED_STEPS:
                self.batches.append(_cpu(batch))
            self.state, metrics = self.trainer.train_step(self.state, batch, self.trainer.cfg.seed)
            if len(self.losses) < JUDGED_STEPS:
                self.losses.append(float(metrics["loss"]))
                if len(self.losses) == 1:
                    b1 = self.trainer.steps.opt.cfg.b1
                    self.first_grad = {n: (m / (1 - b1)).cpu() for n, m in self.state.opt_state.mu.items()}
                if len(self.losses) == JUDGED_STEPS:
                    self.params3 = {n: p.detach().cpu().clone() for n, p in self.state.params.items()}
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def _apply_fault(self):
        if self.fault == "unchanged":
            self.trainer.steps.opt.update = lambda params, grads, state: None
        elif self.fault == "half_batch":
            from matcha_tpu_torch.train.step import Batch

            step = self.trainer.train_step

            def half(state, batch, seed):
                keep = max(1, batch.x.shape[0] // 2)
                return step(state, Batch(*(None if t is None else t[:keep] for t in batch)), seed)

            self.trainer.train_step = half

    def window(self, tracer):
        import torch

        run, trainer = self.run, self.trainer
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        run.t0 = t0 = time.perf_counter()
        t_end = t0 + run.seconds
        epoch, stop = 1, False
        while not stop:
            losses = []
            t_epoch = time.time()
            batches = trainer._prefetch(trainer.dm.train_batches(epoch))
            while True:
                t_wait = time.perf_counter()
                with run.span("batch wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                t_step = time.perf_counter()
                with run.span("train step"):
                    self.state, metrics = trainer.train_step(self.state, batch, trainer.cfg.seed)
                losses.append(metrics["loss"])
                if self.state.step % trainer.cfg.log_every_n_steps == 0:
                    with run.span("log"):
                        trainer.logger.log(self.state.step, metrics)
                run.steps.append({"wait_s": t_step - t_wait, "rows": batch.x.shape[0], "ty": batch.y.shape[1],
                                  "x_lengths": batch.x_lengths, "y_lengths": batch.y_lengths,
                                  "weights": batch.weights})
                now = time.perf_counter()
                tracer.poll(now)
                if now >= t_end:
                    stop = True
                    break
            batches.close()
            trainer.logger.log(self.state.step, {
                "loss/train_epoch": float(torch.stack(losses).mean()) if losses else 0.0,
                "epoch": epoch, "epoch_seconds": time.time() - t_epoch})
            epoch += 1
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
        tracer.stop()
        for s in run.steps:  # lengths to the host, after the window
            w = s.pop("weights")
            w = np.ones(s["rows"], np.float32) if w is None else w.float().cpu().numpy()
            s["x_lengths"] = s["x_lengths"].cpu().numpy()
            s["y_lengths"] = s["y_lengths"].cpu().numpy()
            s["real"] = w > 0
        run.extra["attempted"] = len(run.steps)
        if run.device.type == "cuda":
            run.extra["peak_mem_window_bytes"] = int(torch.cuda.max_memory_allocated())

    def release(self):
        import torch

        self.trainer.close()
        del self.trainer, self.state
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def rebuilt_batches(self) -> tuple[list[dict], int]:
        """The judged batches made again from the corpus files, and the
        number of rows whose fed tensors differ from them."""
        import torch

        index = {}
        with open(os.path.join(self.root, "train.csv")) as f:
            for line in f:
                rel, spk, _, _, ids = line.rstrip("\n").split("|")
                index[tuple(int(i) for i in ids.split())] = (rel, int(spk))
        out, bad = [], 0
        for fed in self.batches:
            b, tx = fed["x"].shape
            ty = fed["y"].shape[1]
            c = fed["y"].shape[2]
            rb = {"x": torch.zeros((b, tx), dtype=torch.long), "x_lengths": torch.zeros(b, dtype=torch.long),
                  "y": torch.zeros((b, ty, c)), "y_lengths": torch.zeros(b, dtype=torch.long),
                  "y_fine": torch.zeros((b, 2 * ty, c)), "y_fine_lengths": torch.zeros(b, dtype=torch.long),
                  "spks": torch.zeros(b, dtype=torch.long), "weights": torch.zeros(b)}
            seen = {}
            for r in range(b):
                ids = tuple(int(i) for i in fed["x"][r, : int(fed["x_lengths"][r])])
                found = index.get(ids)
                if found is None:
                    bad += 1
                    continue
                rel, spk = found
                coarse = np.load(os.path.join(self.root, "mels", f"{rel}.npy")).T
                fine = np.load(os.path.join(self.root, "mels", f"{rel}.fine.npy")).T
                rb["x"][r, : len(ids)] = torch.tensor(ids)
                rb["x_lengths"][r] = len(ids)
                rb["y"][r, : len(coarse)] = torch.from_numpy(coarse)
                rb["y_lengths"][r] = len(coarse)
                rb["y_fine"][r, : len(fine)] = torch.from_numpy(fine)
                rb["y_fine_lengths"][r] = len(fine)
                rb["spks"][r] = spk
                # a repeat of an earlier row fills the batch, out of the loss
                rb["weights"][r] = 0.0 if ids in seen else 1.0
                seen[ids] = r
                fed_w = 1.0 if fed.get("weights") is None else float(fed["weights"][r])
                same = (fed_w == float(rb["weights"][r])
                        and all(torch.equal(fed[k][r].to(rb[k].dtype), rb[k][r])
                                for k in ("x", "x_lengths", "y", "y_lengths", "y_fine", "y_fine_lengths", "spks")))
                bad += 0 if same else 1
            out.append(rb)
        return out, bad

    def judge(self, control: bool = False):
        from benchmark.reference import model as ref_model
        from benchmark.reference import train as ref

        run = self.run
        batches, bad_rows = self.rebuilt_batches()
        params, _ = make_weights(run.cfg, run.seed, run.device, vocoder=False)
        params = {k: v.cpu() for k, v in params.items()}
        got = ref.run_steps(run.cfg, params, batches, run.seed, run.device)
        readings, run.extra["worst_leaf"] = compare(self, got)
        limits = run.extra["limits"]
        for name, value in readings.items():
            run.checks[name] = {"value": value, "limit": limits[name]}
        run.checks["rows_rebuilt_differ"] = {"value": bad_rows, "limit": 0}
        if control:
            with ref_model.precision("fp8"):
                low = ref.run_steps(run.cfg, params, batches, run.seed, run.device)
            stand_in = _Readings(low["losses"], low["first_grad"], low["params"], params)
            run.extra["control"], run.extra["control_worst_leaf"] = compare(stand_in, got)


class _Readings:
    """A stand-in's readings in the program's place (the control)."""

    def __init__(self, losses, first_grad, params3, params0):
        self.losses = [x["loss"] for x in losses]
        self.first_grad, self.params3, self.params0 = first_grad, params3, params0


def norm_gaps(program: dict, reference: dict, leaves) -> tuple[float, str]:
    """The worst leaf's |‖program‖ − ‖reference‖|, over the larger of that
    leaf's reference norm and the median leaf's; and that leaf's name."""
    p = {n: float(program[n].float().norm()) for n in leaves}
    r = {n: float(reference[n].float().norm()) for n in leaves}
    med = float(np.median(list(r.values())))
    gap = {n: abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in leaves}
    worst = sorted(gap, key=gap.get, reverse=True)
    return gap[worst[0]], [(n, gap[n], p[n], r[n]) for n in worst[:4]]


def median_gap(program: dict, reference: dict, leaves) -> float:
    """The median leaf's |‖program‖ − ‖reference‖| / ‖reference‖."""
    return float(np.median([abs(float(program[n].float().norm()) - float(reference[n].float().norm()))
                            / max(float(reference[n].float().norm()), 1e-30) for n in leaves]))


def compare(program, got: dict) -> dict:
    """The three numbers compared, from the program's readings (``program``:
    losses, first_grad, params0, params3) and the reference's ``got``."""
    ref_losses = [x["loss"] for x in got["losses"]]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program.losses, ref_losses))
    leaves = list(got["first_grad"])
    grad_gap, grad_leaf = norm_gaps(program.first_grad, got["first_grad"], leaves)
    # leaves the reference's loss does not move: a gradient under a
    # thousandth of the median leaf's moves under Adam by round-off alone
    gnorm = {n: float(got["first_grad"][n].norm()) for n in leaves}
    med = float(np.median(list(gnorm.values())))
    moved = [n for n in leaves if gnorm[n] >= 1e-3 * med]
    change_p = {n: program.params3[n].float() - program.params0[n].float() for n in moved}
    change_r = {n: got["params"][n] - program.params0[n].float() for n in moved}
    change_gap, change_leaf = norm_gaps(change_p, change_r, moved)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap},
            {"grad_gap": grad_leaf, "change_gap": change_leaf,
             "change_gap_median_leaf": median_gap(change_p, change_r, moved),
             "grad_gap_median_leaf": median_gap(program.first_grad, got["first_grad"], leaves)})
