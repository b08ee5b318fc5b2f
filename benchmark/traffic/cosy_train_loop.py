"""CosyVoice 2's flow stage trained by the trainer's own epochs over the
mix's corpus of speech tokens (``benchmark/training.py``'s loop, window and
rebuilt batches), the model built from the configuration's ``model`` and
judged by the plain fp32 reference ``reference/cosyflow.py``.

The corpus is this driver's own: ``training.corpus_dir`` draws ids below
600 at a fraction of a frame, where a row here holds tokens below 6,561
at exactly half its (even) frame count.  The token counts are lognormal
from the mix's ``base_seed``, clipped; the mels normal, the coarse frames
the mean of each pair of fine ones, as ``corpus_dir`` writes them.

Judgement: the judged steps are the first three of epoch 0 and, where
those are all streaming or all not, on to the first step of the other
kind (from the reference's own draws), so every run holds both the
chunk-causal masks and the unmasked ones to the reference.  Their batches
are rebuilt row by row from the corpus files, and the reference's steps
from the same weights are compared with the program's (``training.compare``).

In the window: each step's streaming draw (``run.steps[i]["streaming"]``,
for ``mfu.cosytrain``), the window's draws and chunk-causal launches
(``run.extra``), and, while the traced slice runs, each K1 and K1b
launch's chunk in the order the tracer records the launches
(``run.extra["launch_chunks"]``, for ``kernels_roofline.cosytrain``): a
wrapper over the kernel wrappers, under the tracer's own.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from benchmark import training, workload_gen
from benchmark.harness import WORK, model_shapes, random_weights
from benchmark.reference import cosyflow as ref

MAX_JUDGED = 12  # at most this many judged steps (all of one kind has p = 2⁻¹¹)
# the kernel wrappers the tracer records, with the kind it records them as
WRAPPED = (("_launch_fwd", "fwd"), ("masked_attention_bwd_dkv", "dkv"), ("masked_attention_bwd_dq", "dq"))


def corpus_dir(spec: dict, base_seed: int, n_feats: int) -> str:
    """The corpus's directory, written on first use: ``train.csv`` and
    channel-major coarse and fine ``.npy`` mels."""
    key = hashlib.sha256(json.dumps([spec, base_seed, n_feats], sort_keys=True).encode()).hexdigest()[:12]
    root = WORK / f"cosy-corpus-{key}"
    if (root / "train.csv").exists():
        return str(root)
    tmp = WORK / f"cosy-corpus-{key}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "mels" / "u").mkdir(parents=True)
    rng = np.random.default_rng(base_seed)
    tokens = workload_gen.lognormal_lengths(rng, {"median": spec["median_tokens"], "sigma": spec["sigma"],
                                                  "min": spec["min_tokens"], "max": spec["max_tokens"]},
                                            spec["utterances"])
    spk = rng.integers(0, spec["speakers"], spec["utterances"])
    rows = []
    for k, (n_tok, s) in enumerate(zip(tokens, spk)):
        urng = np.random.default_rng([base_seed, k])
        frames = int(n_tok) * spec["token_mel_ratio"]
        fine = urng.standard_normal((n_feats, 2 * frames), dtype=np.float32)
        np.save(tmp / "mels" / "u" / f"{k:05d}.npy", 0.5 * (fine[:, ::2] + fine[:, 1::2]))
        np.save(tmp / "mels" / "u" / f"{k:05d}.fine.npy", fine)
        ids = " ".join(map(str, urng.integers(0, spec["vocab"], int(n_tok))))
        rows.append(f"u/{k:05d}|{int(s)}|en-us|utterance {k}|{ids}")
    (tmp / "mels" / "metadata.json").write_text(json.dumps({"n_mels": n_feats}))
    (tmp / "train.csv").write_text("\n".join(rows) + "\n")
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    os.sync()  # the corpus's writeback in set-up, not in the window
    return str(root)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The flow stage's state_dict from ``seed`` on ``device``, in one draw,
    by the harness's rule (``harness.random_weights``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    return random_weights(model_shapes(ref.CosyFlow, cfg["model"]), gen, device)


def judged_steps(seed: int) -> int:
    """The first three steps, and on to the first step of the kind (streaming
    or not) the three lack."""
    kinds = [ref.draws(seed, s, 1)[0] for s in range(MAX_JUDGED)]
    n = training.JUDGED_STEPS
    while n < MAX_JUDGED and len(set(kinds[:n])) < 2:
        n += 1
    return n


class Driver(training.Driver):
    def setup(self):
        import torch

        from matcha_tpu_torch.data.dataset import TextMelDataset
        from matcha_tpu_torch.models.config import CosyFlowConfig
        from matcha_tpu_torch.train.optim import OptimizerConfig
        from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

        run, tr = self.run, self.run.cfg["training"]
        n_feats = run.cfg["model"]["n_feats"]
        self.root = corpus_dir(run.mix["corpus"], run.mix["base_seed"], n_feats)
        logs = WORK / "train-logs"
        shutil.rmtree(logs, ignore_errors=True)
        self.trainer = Trainer(
            CosyFlowConfig.from_dict(run.cfg["model"]), OptimizerConfig(**tr["optimizer"]),
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
        self.judged = judged_steps(run.seed)
        self.batches, self.losses = [], []
        # epoch 0: the judged steps first, then every shape it packs
        for batch in self.trainer._prefetch(self.trainer.dm.train_batches(0)):
            if len(self.batches) < self.judged:
                self.batches.append(training._cpu(batch))
            self.state, metrics = self.trainer.train_step(self.state, batch, self.trainer.cfg.seed)
            if len(self.losses) < self.judged:
                self.losses.append(float(metrics["loss"]))
                if len(self.losses) == 1:
                    b1 = self.trainer.steps.opt.cfg.b1
                    self.first_grad = {n: (m / (1 - b1)).cpu() for n, m in self.state.opt_state.mu.items()}
                if len(self.losses) == self.judged:
                    self.params3 = {n: p.detach().cpu().clone() for n, p in self.state.params.items()}
        if len(self.losses) < self.judged:
            raise RuntimeError(f"epoch 0 has {len(self.losses)} steps, fewer than the {self.judged} judged")
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def _apply_fault(self):
        if self.fault == "no_chunk":  # the chunk masks ignored: every step trains unmasked
            model = self.trainer.steps.model
            step_kwargs = model.step_kwargs
            model.step_kwargs = lambda seed, step, count: {**step_kwargs(seed, step, count), "streaming": False}
        else:
            super()._apply_fault()

    def window(self, tracer):
        from matcha_tpu_torch.ops import attention

        model = self.trainer.steps.model
        drawn, step0 = dict(model.drawn), self.state.step
        record, chunked, restore = [], [0], []

        def wrap(name, kind):
            orig = getattr(attention, name)

            def wrapped(*a, **k):
                chunk = int(k.get("chunk", 0))
                chunked[0] += chunk > 0
                if tracer.prof is not None and not tracer.done:  # the tracer's slice: its launch order
                    record.append((kind, chunk))
                return orig(*a, **k)

            setattr(attention, name, wrapped)
            restore.append((name, orig))

        for name, kind in WRAPPED:
            wrap(name, kind)
        try:
            super().window(tracer)
        finally:
            for name, orig in restore:
                setattr(attention, name, orig)
        for i, s in enumerate(self.run.steps):
            s["streaming"] = ref.draws(self.run.seed, step0 + i, 1)[0]
        self.run.extra["window_drawn"] = {k: v - drawn[k] for k, v in model.drawn.items()}
        self.run.extra["window_chunked_launches"] = chunked[0]
        if self.run.trace:
            self.run.extra["launch_chunks"] = record

    def judge(self, control: bool = False):
        run = self.run
        batches, bad_rows = self.rebuilt_batches()
        params = {k: v.cpu() for k, v in make_weights(run.cfg, run.seed, run.device).items()}
        got = ref.run_steps(run.cfg, params, batches, run.seed, run.device)
        run.extra["judged_draws"] = [(x["streaming"], x["prompted"], x["dropped"]) for x in got["losses"]]
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
