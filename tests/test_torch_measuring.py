"""The port's measuring modules: ``utils/{profiling,trace_analysis,probe,backend_wait}.py``.

- ``device_stats`` on a hand-built Chrome trace: kernels overlapping on two
  streams count once (the union), memcpy and memset count, host events do
  not; per-kernel totals and the wall span are exact sums of the events.
- ``trace`` + ``device_stats`` on a CPU run: zero device time, a wall span,
  the ``annotate`` range in the trace.
- ``inner_repeat``'s formula on a fake clock (exact), and on the CPU for
  real; ``wait_for_backend`` with budget 0 (no probe) and with a probe that
  keeps failing (gives up after the budget, says so).
- On the card, ``tests/test_torch_cuda_tools.py`` holds the probe's
  CUDA-graph path and a real profiler trace.
"""

from __future__ import annotations

import json
import subprocess
from types import SimpleNamespace as NS

import pytest
import torch

from matcha_tpu_torch.utils import backend_wait, probe, profiling, trace_analysis


def _event(name, cat, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}


def _write_trace(path, events):
    meta = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
            {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
            {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python3"}}]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": meta + events}))


# ``trace`` writes one file a block: the union runs over every file under logdir
@pytest.mark.parametrize("files", [1, 2], ids=["one_trace", "two_blocks"])
def test_device_stats_union_on_a_hand_built_trace(tmp_path, files):
    events = [
        _event("aten::mm", "cpu_op", 0.0, 400.0, pid=4242, tid=1),   # host: not device time
        _event("kernA", "kernel", 100.0, 50.0, tid=7),               # stream 7: [100, 150)
        _event("kernB", "kernel", 120.0, 60.0, tid=13),              # stream 13: [120, 180), overlaps A
        _event("kernA", "kernel", 200.0, 10.0, tid=7),               # [200, 210)
        _event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 205.0, 20.0, tid=7),  # [205, 225)
        _event("Memset (Device)", "gpu_memset", 300.0, 5.0, tid=13),  # [300, 305)
        _event("cudaLaunchKernel", "cuda_runtime", 99.0, 3.0, pid=4242, tid=1),
    ]
    if files == 1:
        _write_trace(tmp_path / "t.json", events)
    else:  # kernB overlaps kernA across the two files
        _write_trace(tmp_path / "a" / "t.json", events[:2] + events[3:5])
        _write_trace(tmp_path / "b" / "t.json", events[2:3] + events[5:])
    stats = trace_analysis.device_stats(tmp_path)
    # union: [100, 180) + [200, 225) + [300, 305) = 80 + 25 + 5 µs
    assert stats["device_busy_ms"] == pytest.approx(0.110, abs=1e-12)
    assert stats["modules"]["kernA"] == {"ms": pytest.approx(0.060), "count": 2}
    assert stats["modules"]["kernB"] == {"ms": pytest.approx(0.060), "count": 1}
    assert list(stats["modules"])[-1] == "Memset (Device)"
    assert stats["wall_span_ms"] == pytest.approx(0.400)
    assert stats["device_planes"] == ["GPU 0"] and stats["device_events"] == 5


def test_device_stats_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_analysis.device_stats(tmp_path)


def test_trace_on_the_cpu_has_no_device_time(tmp_path, capsys):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("matmul_block"):
            for _ in range(3):
                x = x @ x * 1e-2
    stats = trace_analysis.device_stats(tmp_path)
    assert stats["device_busy_ms"] == 0.0 and stats["modules"] == {} and stats["device_planes"] == []
    assert stats["wall_span_ms"] > 0.0
    (trace,) = tmp_path.glob("*.json")
    assert "matmul_block" in trace.read_text()
    trace_analysis.main([str(tmp_path)])
    assert json.loads(capsys.readouterr().out)["device_busy_ms"] == 0.0


class FakeClock:
    """Every read costs ``fixed`` seconds; each ``fn`` call costs ``device``."""

    def __init__(self, fixed, device):
        self.now, self.fixed, self.device = 0.0, fixed, device

    def perf_counter(self):
        t = self.now
        self.now += self.fixed
        return t

    def work(self, acc):
        self.now += self.device
        return acc + 1.0


@pytest.mark.parametrize("k", [2, 4])
def test_inner_repeat_formula_on_a_fake_clock(monkeypatch, k):
    clock = FakeClock(fixed=0.25, device=0.5)
    monkeypatch.setattr(probe, "time", clock)
    out = probe.inner_repeat(lambda acc, x: clock.work(acc), torch.zeros(3), k=k, reps=3)
    assert out == {"device_ms": 500.0, "fixed_ms": 250.0}


def test_inner_repeat_on_the_cpu():
    x = torch.randn(32, 32)
    calls = []

    def fn(acc, x):
        calls.append(1)
        return (x + acc).sum() * 1e-12

    out = probe.inner_repeat(fn, x, k=3, reps=2)
    assert set(out) == {"device_ms", "fixed_ms"}
    # per timed length: one warm-up and ``reps`` runs; lengths 1 and k
    assert len(calls) == (1 + 2) * 1 + (1 + 2) * 3


def test_wait_for_backend_budget_zero_runs_no_probe(monkeypatch):
    monkeypatch.setenv("BENCH_WAIT_BACKEND_S", "0")
    monkeypatch.setattr(backend_wait, "subprocess", NS(run=lambda *a, **k: pytest.fail("probe ran"),
                                                       TimeoutExpired=subprocess.TimeoutExpired))
    backend_wait.wait_for_backend()


def test_wait_for_backend_gives_up_after_the_budget(monkeypatch, capsys):
    monkeypatch.setenv("MY_WAIT", "100")
    probes, now = [], [0.0]

    def failing_probe(cmd, **kw):
        probes.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, b"", b"Traceback\nRuntimeError: CUDA unavailable")

    monkeypatch.setattr(backend_wait, "subprocess", NS(run=failing_probe, TimeoutExpired=subprocess.TimeoutExpired))
    monkeypatch.setattr(backend_wait, "time", NS(time=lambda: now[0],
                                                 sleep=lambda s: now.__setitem__(0, now[0] + s)))
    backend_wait.wait_for_backend("MY_WAIT")
    err = capsys.readouterr().err
    assert len(probes) == 3  # at 0, 60 and 120 s
    assert probes[0][-1] == backend_wait.PROBE and "cuda" in backend_wait.PROBE
    assert err.count("backend unavailable (RuntimeError: CUDA unavailable); retrying in 60s") == 2
    assert "backend still unavailable after 120s; proceeding" in err
