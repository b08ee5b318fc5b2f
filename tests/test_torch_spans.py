"""The program's spans (``utils/profiling.annotate``) and their reading
(``utils/trace_analysis.span_stats``), on the CPU.

- With no profiler running, ``annotate`` hands out one shared null context.
- Under ``profiling.trace``, each ``TrainStep.train_step`` writes one
  ``matcha/train.step`` range holding forward, backward, optimizer and
  metrics in that order, and each forward holds encoder, MAS, CFM and the
  diagnostics; the trainer's prefetch writes one ``matcha/loader.wait`` a
  batch (and one for the end of the batches).
- The spans change no result: three steps give bit-equal losses and
  parameters with a profiler running and without one.
- ``span_stats`` on a hand-built Chrome trace, in one file and split over
  two whose correlation ids collide: per-step wall ms and device events
  exact, the autograd engine thread's launches counted in the step
  thread's innermost span, launches under ``loader.wait`` or with no launch
  left out of the step, idle gaps labelled by the innermost span; and a
  trace without a step.
"""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace as NS

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import TrainStep
from matcha_tpu_torch.train.trainer import Trainer
from matcha_tpu_torch.utils import profiling, trace_analysis
from matcha_tpu_torch.utils.profile_step import synthetic_batch

PHASES = ["matcha/train.forward", "matcha/train.backward", "matcha/train.optimizer", "matcha/train.metrics"]
FORWARD = ["matcha/train.encoder", "matcha/train.mas", "matcha/train.cfm", "matcha/train.diagnostics"]


def test_annotate_without_a_profiler_is_one_shared_null_context():
    first = profiling.annotate("matcha/a")
    assert profiling.annotate("matcha/b") is first
    with first, profiling.annotate("matcha/c"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.annotate("matcha/a") is not first
    assert profiling.annotate("matcha/a") is first


def _train(steps: int, logdir=None):
    """``steps`` CPU steps of a tiny ``TrainStep`` on one batch, under
    ``profiling.trace(logdir)`` when a directory is given."""
    cfg = tiny_config()
    ts = TrainStep(cfg, OptimizerConfig(), device="cpu")
    state = ts.init_state(generator=torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 2, 8, 16)
    losses = []
    with profiling.trace(str(logdir)) if logdir else contextlib.nullcontext():
        for _ in range(steps):
            state, metrics = ts.train_step(state, batch, 0)
            losses.append(metrics["loss"])
    return losses, state.params


def _annotations(logdir) -> list[dict]:
    (path,) = logdir.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((ev for ev in events if ev.get("cat") == "user_annotation" and ev["name"].startswith("matcha/")),
                  key=lambda ev: ev["ts"])


def _inside(outer: dict, events: list[dict]) -> list[dict]:
    return [ev for ev in events if ev is not outer and ev["tid"] == outer["tid"]
            and outer["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"]]


def test_each_step_writes_its_phases_in_order(tmp_path):
    _train(2, tmp_path)
    spans = _annotations(tmp_path)
    steps = [ev for ev in spans if ev["name"] == "matcha/train.step"]
    assert len(steps) == 2
    for step in steps:
        inside = _inside(step, spans)
        phases = [ev for ev in inside if ev["name"] in PHASES]
        assert [ev["name"] for ev in phases] == PHASES
        assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(phases, phases[1:]))
        assert [ev["name"] for ev in _inside(phases[0], spans)] == FORWARD
        assert {ev["name"] for ev in inside} == set(PHASES) | set(FORWARD)
    stats = trace_analysis.span_stats(tmp_path)
    assert stats["steps"] == 2 and set(stats["per_step"]) == {"matcha/train.step", *PHASES, *FORWARD}
    assert stats["per_step"]["matcha/train.step"]["launches"] == 0  # no device here


def test_spans_change_no_result(tmp_path):
    plain_losses, plain_params = _train(3)
    traced_losses, traced_params = _train(3, tmp_path)
    assert _annotations(tmp_path)  # the profiler did record the spans
    assert all(torch.equal(a, b) for a, b in zip(plain_losses, traced_losses))
    assert all(torch.equal(plain_params[n], traced_params[n]) for n in plain_params)


def test_prefetch_waits_once_a_batch(tmp_path):
    cfg = tiny_config()
    batches = [synthetic_batch(cfg, 2, 8, 16, seed=i) for i in range(3)]
    with profiling.trace(str(tmp_path)):
        got = list(Trainer._prefetch(NS(device=torch.device("cpu")), iter(batches)))
    assert len(got) == 3
    waits = [ev for ev in _annotations(tmp_path) if ev["name"] == "matcha/loader.wait"]
    assert len(waits) == 3 + 1  # and one that receives the end of the batches
    stats = trace_analysis.span_stats(tmp_path)
    assert stats["loader_wait_ms"] == pytest.approx(sum(ev["dur"] for ev in waits) / 4 / 1e3)


# ---------------------------------------------------------------- hand-built traces

STEP_THREAD, ENGINE_THREAD = 1, 2
# (name, start µs, end µs) of one step; the second step is the same, 1,100 µs later
ONE_STEP = [("train.step", 0, 1000), ("train.forward", 10, 400), ("train.encoder", 15, 100),
            ("train.mas", 100, 200), ("train.cfm", 200, 300), ("train.diagnostics", 300, 390),
            ("train.backward", 400, 700), ("train.optimizer", 700, 950), ("train.metrics", 950, 990)]
# (correlation, launching thread or None for no launch event, launch µs, device start µs, end µs, category)
LAUNCHES = [
    (1, STEP_THREAD, 30, 40, 60, "kernel"),             # step 1, encoder
    (2, ENGINE_THREAD, 450, 460, 500, "kernel"),        # step 1, backward (the engine's thread)
    (3, STEP_THREAD, 720, 730, 900, "kernel"),          # step 1, optimizer
    (4, STEP_THREAD, 1010, 1020, 1030, "gpu_memcpy"),   # loader.wait, between the steps
    (5, STEP_THREAD, 1130, 1140, 1160, "kernel"),       # step 2, encoder
    (6, None, 0, 1200, 1210, "gpu_memset"),             # no launch in the trace
    (7, ENGINE_THREAD, 1550, 1560, 1570, "kernel"),     # step 2, backward (the engine's thread)
    (8, None, 0, 2250, 2260, "kernel"),                 # no launch, after the steps
]


def _x(name, cat, ts, dur, tid, pid=10, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))


def _hand_built(root, files: int, steps: bool = True):
    """Two steps, a loader wait between them and a host op at the end, in
    one trace file or split over two at 1,050 µs; the second file numbers
    its correlations from 1 again, as a second profiling session may."""
    parts = [[], []]
    for k in range(2 if steps else 0):
        for name, s, e in ONE_STEP:
            t = s + 1100 * k
            parts[k].append(_x("matcha/" + name, "user_annotation", t, e - s, STEP_THREAD))
    parts[0].append(_x("matcha/loader.wait", "user_annotation", 1000, 100, STEP_THREAD))
    renumber = {}
    for corr, thread, launch, s, e, cat in LAUNCHES:
        part = 0 if s < 1050 or files == 1 else 1
        c = corr if part == 0 else renumber.setdefault(corr, len(renumber) + 1)
        if thread is not None:
            parts[part].append(_x("cudaLaunchKernel", "cuda_runtime", launch, 2, thread, corr=c))
        parts[part].append(_x("dev", cat, s, e - s, 7, pid=0, corr=c))
    parts[1].append(_x("aten::empty", "cpu_op", 2300, 100, STEP_THREAD))
    if files == 1:
        _write(root / "t.json", parts[0] + parts[1])
    else:
        _write(root / "a" / "t.json", parts[0])
        _write(root / "b" / "t.json", parts[1])


@pytest.mark.parametrize("files", [1, 2], ids=["one_trace", "two_traces"])
def test_span_stats_per_step(tmp_path, files):
    _hand_built(tmp_path, files)
    stats = trace_analysis.span_stats(tmp_path)
    per = stats["per_step"]
    assert stats["steps"] == 2
    # steps 1 and 2 launch 3 and 2 events; the engine's count in backward
    assert per["matcha/train.step"] == {"ms": pytest.approx(1.0), "launches": 2.5}
    assert per["matcha/train.forward"] == {"ms": pytest.approx(0.39), "launches": 1.0}
    assert per["matcha/train.encoder"] == {"ms": pytest.approx(0.085), "launches": 1.0}
    assert per["matcha/train.backward"] == {"ms": pytest.approx(0.3), "launches": 1.0}
    assert per["matcha/train.optimizer"] == {"ms": pytest.approx(0.25), "launches": 0.5}
    assert per["matcha/train.metrics"] == {"ms": pytest.approx(0.04), "launches": 0.0}
    assert stats["phases_cover"] == {"min": pytest.approx(0.98), "mean": pytest.approx(0.98)}
    assert stats["loader_wait_ms"] == pytest.approx(0.1)
    assert stats["unassigned_events"] == 2  # the copy under loader.wait is assigned, to it


@pytest.mark.parametrize("files", [1, 2], ids=["one_trace", "two_traces"])
def test_span_stats_idle_gaps_by_innermost_span(tmp_path, files):
    _hand_built(tmp_path, files)
    gaps = trace_analysis.span_stats(tmp_path)["idle_gaps_program"]
    # gaps [0, 40) [60, 460) [500, 730) [900, 1020) [1030, 1140) [1160, 1200)
    # [1210, 1560) [1570, 2250) [2260, 2400) µs, by the span open at each middle
    expected = {"matcha/train.encoder": 80, "matcha/train.cfm": 750, "matcha/train.backward": 230,
                "matcha/train.metrics": 120, "matcha/loader.wait": 110, "matcha/train.optimizer": 680,
                trace_analysis.NO_SPAN: 140}
    assert gaps == {k: pytest.approx(v / 1e6) for k, v in expected.items()}
    assert list(gaps)[0] == "matcha/train.cfm"  # the most idle first
    assert sum(gaps.values()) == pytest.approx(
        trace_analysis.device_stats(tmp_path)["wall_span_ms"] / 1e3
        - trace_analysis.device_stats(tmp_path)["device_busy_ms"] / 1e3)


def test_span_stats_without_a_step(tmp_path):
    _hand_built(tmp_path / "wait", 1, steps=False)
    stats = trace_analysis.span_stats(tmp_path / "wait")
    assert stats["steps"] == 0 and stats["per_step"] == {} and stats["phases_cover"] is None
    assert stats["loader_wait_ms"] == pytest.approx(0.1)
    assert set(stats["idle_gaps_program"]) == {trace_analysis.NO_SPAN}
    assert stats["unassigned_events"] == len(LAUNCHES) - 1  # the copy under loader.wait alone
    _write(tmp_path / "bare" / "t.json", [_x("aten::mm", "cpu_op", 0, 10, STEP_THREAD)])
    bare = trace_analysis.span_stats(tmp_path / "bare")
    assert bare["loader_wait_ms"] is None and bare["steps"] == 0
    assert bare["idle_gaps_program"] == {trace_analysis.NO_SPAN: pytest.approx(10e-6)}
