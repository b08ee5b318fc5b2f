"""The served path under test, and its judgement.

Set-up builds the program's ``MatchaSynthesizer`` with weights made from
the seed on the device, wraps it in the program's ``TTSService`` (its
request batcher and every knob at the program's own defaults) and warms
the (group size, text bucket, mel bucket) shapes the cell's traffic can
reach, through the same ``synthesise_batch`` the batcher calls.  A request
is ``TTSService.speak`` with phoneme ids and ``response_format: wav``, on a
thread of its own, as an HTTP handler thread calls it.

The benchmark's own wrapper around the synthesizer instance's
``synthesise_batch`` records each group call (start, end, rows) and opens
the ``group call`` span; ``speak`` opens the ``speak`` span.

Judgement: a sample of the requests completed in the window, drawn from
the seed, with the longest among them, each worked out again by the plain
fp32 reference (``reference/synthesis.py``) from the same weights, ids and
voice; the number compared is the widest relative L2 distance between a
served WAV and its reference (``audio_rel_err``).
"""

from __future__ import annotations

import gc
import io
import threading
import time
import wave

import numpy as np

from benchmark import workload_gen
from benchmark.harness import Run, make_weights


def _np_wav(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / 32767.0


class Serving:
    def __init__(self, run: Run, fault=None):
        self.run = run
        self.fault = fault  # tests: a function altering the group's results

    # -------------------------------------------------------------- set-up

    def setup(self):
        import torch

        from matcha_tpu_torch.inference import MatchaSynthesizer
        from matcha_tpu_torch.models.config import MatchaConfig
        from matcha_tpu_torch.serving.server import TTSService
        from matcha_tpu_torch.vocoder.vocos import VocosConfig

        run = self.run
        params, vparams = make_weights(run.cfg, run.seed, run.device, vocoder=True)
        # the synthesizer blends speaker embeddings on the host
        for k in ("speaker_embeddings_enc.weight", "speaker_embeddings_dur.weight"):
            params[k] = params[k].cpu()
        synth = MatchaSynthesizer(MatchaConfig.from_dict(run.cfg["model"]), params, vparams,
                                  VocosConfig(**run.cfg["vocos"]), device=run.device)
        del params, vparams
        orig = synth.synthesise_batch

        def group_call(id_lists, *a, **k):
            t0 = time.perf_counter()
            with run.span("group call"):
                out = orig(id_lists, *a, **k)
            run.group_calls.append((t0, time.perf_counter(), len(id_lists)))
            if self.fault is not None and run.t0 and t0 >= run.t0:  # tests: break the timed path
                out = self.fault(id_lists, out)
            return out

        synth.synthesise_batch = group_call
        self.synth = synth
        self.service = TTSService(synth)
        self.service.warmup()
        self._warm_shapes()
        for body in workload_gen.request_pool(run.mix, run.seed + 1, 2):
            self.service.speak(body)
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        run.group_calls.clear()
        run.spans.clear()

    def _warm_shapes(self):
        """One group call at each (rows, text bucket, mel bucket) the traffic
        can reach: the rows pad to powers of two up to the batcher's largest
        group (or the clients there are), the text bucket holds the mix's
        lengths, and the mel bucket follows from the slowest and fastest
        voice's duration correction."""
        from matcha_tpu_torch.inference import pick_bucket

        synth, mix = self.synth, self.run.mix
        most = self.service.batcher.max_batch if self.service.batcher else 1
        if "clients" in mix:
            most = min(most, mix["clients"])
        sizes = sorted({1 << (b - 1).bit_length() for b in range(1, most + 1)})
        lo, hi = mix["ids"]["min"], mix["ids"]["max"]
        txs = sorted({pick_bucket(n, synth.text_buckets) for n in range(lo, hi + 1)})
        corr = self.run.cfg["serving"]["scale_corrections"]
        slow = max(corr, key=corr.get)
        fast = next((str(v) for v in range(mix["voices"]["count"]) if str(v) not in corr), min(corr, key=corr.get))
        for tx in txs:
            n = max(lo, min(tx, hi))
            ids = list(range(1, n + 1))
            for b in sizes:
                for v in (fast, slow):
                    synth.synthesise_batch([ids] * b, voice_mixes=[[(int(v), 1.0)]] * b,
                                           fused=self.service.fused,
                                           n_timesteps=self.service.default_steps,
                                           solver=self.service.default_solver)

    # -------------------------------------------------------------- requests

    def request(self, body: dict, due: float) -> dict:
        rec = {"due": due, "n": len(body["phoneme_ids"]), "body": body, "ok": False}
        try:
            with self.run.span("speak"):
                data, _ = self.service.speak(body)
            rec["done"] = time.perf_counter()
            rec["wav"] = data
            rec["audio_s"] = (len(data) - 44) / 2 / self.run.cfg["vocos"]["sample_rate"]
            rec["ok"] = True
        except Exception as exc:  # a failed request is counted, and judged wrong
            rec["done"] = time.perf_counter()
            rec["error"] = repr(exc)
        with self.run.lock:
            self.run.requests.append(rec)
        return rec

    def spawn(self, body: dict, due: float) -> threading.Thread:
        th = threading.Thread(target=self.request, args=(body, due), daemon=True)
        th.start()
        return th

    # -------------------------------------------------------------- after the window

    def release(self):
        """Stop the batcher and free the program's state on the device."""
        import torch

        if self.service.batcher is not None:
            self.service.batcher.shutdown()
        del self.service, self.synth
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, control: bool = False):
        """Fill ``run.checks``; with ``control``, also the reading of the
        reference computed in fp8 in the program's place."""
        import torch

        from benchmark.reference import model as ref_model
        from benchmark.reference import synthesis as ref
        from benchmark.reference.noise import seeded_synthesis_noise

        run = self.run
        done = [r for r in run.requests if r["ok"] and r["due"] <= run.t0 + run.window_s]
        k = run.mix["judge"]["requests"]
        rng = np.random.default_rng([run.seed, 3])
        longest = max(range(len(done)), key=lambda i: done[i]["n"], default=None)
        picked = [] if longest is None else [longest]
        rest = [i for i in range(len(done)) if i != longest]
        picked += [rest[i] for i in rng.permutation(len(rest))[: max(0, k - 1)]]
        failed = run.extra.get("attempted", len(run.requests)) - sum(1 for r in run.requests if r["ok"])
        run.extra["failed"] = failed
        params, vparams = make_weights(run.cfg, run.seed, run.device, vocoder=True)
        model, vocos = ref.build(run.cfg, params, vparams, run.device)
        del params, vparams
        t_max = max((4 * done[i]["n"] * 2 for i in picked), default=8) + 8
        noise = seeded_synthesis_noise(t_max, run.cfg["model"]["n_feats"],
                                       run.cfg["serving"]["noise_seed"]).to(run.device)
        gaps, control_gaps, detail = [], [], []
        sr = run.cfg["vocos"]["sample_rate"]
        for i in picked:
            body = done[i]["body"]
            mix = workload_gen.voice_mix(body["voice"])
            refs = ref.waveforms(model, vocos, run.cfg, body["phoneme_ids"], mix, noise)
            served = _np_wav(done[i]["wav"])
            gaps.append(min(ref.audio_rel_err(served, r) for r in refs))
            # (ids, relative error, log-mel gap in dB): for control.py's look
            detail.append((done[i]["n"], gaps[-1], min(ref.audio_gap_db(served, r, sr) for r in refs)))
            if control:
                with ref_model.precision("fp8"):
                    low = ref.waveforms(model, vocos, run.cfg, body["phoneme_ids"], mix, noise)
                control_gaps.append(min(ref.audio_rel_err(lo, r) for lo, r in zip(low, refs)))
        del model, vocos
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        limits = run.extra["limits"]
        run.checks["audio_rel_err"] = {"value": max(gaps, default=float("inf")),
                                       "limit": limits["audio_rel_err"]}
        run.checks["requests_failed"] = {"value": failed, "limit": 0}
        run.extra["judged"] = {"requests": len(gaps), "ids": sum(done[i]["n"] for i in picked),
                               "detail": detail}
        if control:
            run.extra["control_audio_rel_err"] = max(control_gaps, default=float("inf"))
