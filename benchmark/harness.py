"""The benchmark's core: files by name, weights from the seed, records,
the traced slice, and the reading of metrics.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by its name:

  benchmark/configs/<config>.json     sizes and dtype, with the source
  benchmark/traffic/<mix>.json        a traffic mix: its driver and parameters
  benchmark/traffic/<driver>.py       a driver: set-up, window, judgement
  benchmark/workloads/<cell>.json     a cell: its configuration and mix
  benchmark/metrics/<metric>.py       ``read(run) -> float | None``

Which metrics a cell reports comes from ``BENCHMARK.json`` at the root of
the checkout.  Nothing here names a cell, a mix or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WORK = BENCH / ".work"  # corpus cache and logs, inside the checkout (gitignored)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet, 700 W)
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "matcha_tpu", "tools")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def load_module(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(BENCH / "traffic" / f"{name}.py", f"benchmark_driver_{name}")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module(BENCH / "metrics" / f"{metric}.py", "benchmark_metric_" + metric.replace(".", "_")).read


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The end-to-end metrics of the cell (trace off) or its per-layer
    metrics (trace on), as BENCHMARK.json lists them."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark must never run."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100, linear interpolation) over all values."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# ------------------------------------------------------------ weights


def model_shapes(module_cls, *args) -> dict[str, tuple]:
    import torch

    with torch.device("meta"):
        return {n: tuple(t.shape) for n, t in module_cls(*args).state_dict().items()}


def random_weights(shapes: dict[str, tuple], gen, device) -> dict:
    """Random weights from ``gen`` in one draw on ``device``, by name: matrices
    and kernels normal with std 1/sqrt(fan-in); embeddings 1/sqrt(width);
    norm scales one; biases, norm shifts and SnakeBeta's log-scale alpha and
    beta zero; the FiLM projection identity (weight 0, bias [1, 0]); Vocos'
    layer scale 1e-6: the recipe's initialisation."""
    import torch

    drawn = [n for n, s in shapes.items() if _init_kind(n, s) == "normal"]
    total = sum(math.prod(shapes[n]) for n in drawn)
    pool = torch.randn((total,), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        kind = _init_kind(name, shape)
        if kind == "normal":
            n = math.prod(shape)
            fan = shape[1] if name.endswith("emb.weight") or name.startswith("speaker_embeddings") \
                else math.prod(shape[1:])
            out[name] = pool[at:at + n].view(shape) * fan ** -0.5
            at += n
        elif kind == "film_bias":
            out[name] = torch.cat([torch.ones(shape[0] // 2, device=device),
                                   torch.zeros(shape[0] - shape[0] // 2, device=device)])
        else:
            out[name] = torch.full(shape, {"zero": 0.0, "one": 1.0, "layer_scale": 1e-6}[kind], device=device)
    return out


def _init_kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if name == "encoder.proj_w.spk_proj.weight":
        return "zero"
    if name == "encoder.proj_w.spk_proj.bias":
        return "film_bias"
    if leaf == "gamma" and name.startswith("backbone.convnext"):
        return "layer_scale"
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return "one"
    if leaf in ("bias", "beta", "alpha"):
        return "zero"
    return "normal"


def make_weights(cfg: dict, seed: int, device, vocoder: bool) -> tuple[dict, dict | None]:
    """(Matcha state_dict, Vocos state_dict or None) from ``seed`` on
    ``device``, the duration head pinned where the configuration says so."""
    import torch

    from benchmark.reference.model import MatchaTTS, Vocos

    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = random_weights(model_shapes(MatchaTTS, cfg["model"]), gen, device)
    pin = cfg.get("pin_fine_frames_per_token")
    if pin:
        params["encoder.proj_w.proj.weight"].zero_()
        params["encoder.proj_w.proj.bias"].fill_(math.log(2.0 + pin))
    vparams = random_weights(model_shapes(Vocos, cfg["vocos"]), gen, device) if vocoder else None
    return params, vparams


# ------------------------------------------------------------ records


@dataclass
class Run:
    """Everything one run records, for the metric readers and the judge."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict
    mix: dict
    device: object
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: list = field(default_factory=list)     # serving: one dict a request due in the window
    group_calls: list = field(default_factory=list)  # serving: (start, end, rows) of each group call
    steps: list = field(default_factory=list)        # training: one dict a step of the window
    spans: list = field(default_factory=list)        # (start_ns, end_ns, name), host clock
    traced: dict | None = None                       # the traced slice (see Tracer)
    extra: dict = field(default_factory=dict)        # driver-specific readings
    checks: dict = field(default_factory=dict)       # {name: {"value", "limit"}} of the judge
    t0: float = 0.0                                  # the window's start (perf_counter); 0 before it
    lock: threading.Lock = field(default_factory=threading.Lock)

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.t = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.run.spans.append((self.t, time.perf_counter_ns(), self.name))


# ------------------------------------------------------------ tracing


class Tracer:
    """Profiles one slice of the window (``trace_start_s`` after it opens,
    ``trace_seconds`` long) with ``torch.profiler``; ``poll`` is called
    from the driver's main thread.  While the slice runs, the launches of
    the hand-written kernels are recorded with their shapes and key masks,
    for the roofline readers."""

    def __init__(self, run: Run, start_s: float, seconds: float):
        self.run, self.start_s, self.seconds = run, start_s, seconds
        self.prof = None
        self.done = False
        self.launches: list = []
        self._restore = []

    def wait_until(self, t: float) -> None:
        """Sleep until ``t`` (perf_counter); in a traced run, in short
        steps that open and close the slice on time."""
        while (now := time.perf_counter()) < t:
            if self.run.trace and not self.done:
                self.poll(now)
                time.sleep(min(0.005, t - now))
            else:
                time.sleep(t - now)

    def poll(self, now: float) -> None:
        if not self.run.trace or self.done:
            return
        t = now - self.run.t0
        if self.prof is None and t >= self.start_s:
            self._start()
        elif self.prof is not None and t >= self.start_s + self.seconds:
            self.stop()

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._wrap_kernels()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.anchor_ns = time.perf_counter_ns()
        with torch.profiler.record_function("benchmark.anchor"):
            pass
        self.t_start = time.perf_counter()

    def stop(self):
        import tempfile

        import torch

        if self.prof is None or self.done:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self._unwrap_kernels()
        self.done = True
        path = Path(tempfile.gettempdir()) / "matcha_benchmark_trace.json"
        self.prof.export_chrome_trace(str(path))
        try:
            from benchmark import trace_reader

            self.run.traced = trace_reader.read(path, self.anchor_ns, self.run.spans, t_end - self.t_start)
        finally:
            path.unlink(missing_ok=True)
        self.run.traced["window_s"] = t_end - self.t_start
        self.run.traced["launches"] = self.launches

    def _wrap_kernels(self):
        from matcha_tpu_torch.ops import attention, mas

        rec = self.launches

        def wrap(mod, name, kind, masks):
            orig = getattr(mod, name)

            def wrapped(*a, **k):
                lse = bool(k.get("with_lse", a[4] if kind == "fwd" and len(a) > 4 else False))
                rec.append((kind, tuple(a[0].shape), str(a[0].dtype).split(".")[-1], lse, masks(a)))
                return orig(*a, **k)

            setattr(mod, name, wrapped)
            self._restore.append((mod, name, orig))

        # (kind, shape, dtype, with_lse, key mask or (x_lengths, y_lengths))
        wrap(attention, "_launch_fwd", "fwd", lambda a: a[3])
        wrap(attention, "masked_attention_bwd_dkv", "dkv", lambda a: a[6])
        wrap(attention, "masked_attention_bwd_dq", "dq", lambda a: a[6])
        wrap(mas, "maximum_path_indices_kernel", "mas", lambda a: (a[1], a[2]))

    def _unwrap_kernels(self):
        for mod, name, orig in self._restore:
            setattr(mod, name, orig)
        self._restore = []


# ------------------------------------------------------------ result


def device_info(run: Run) -> dict:
    import torch

    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.traced is not None:
        info["busy_s"] = run.traced["busy_s"]
        info["window_s"] = run.traced["window_s"]
    return info


def read_metrics(run: Run, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
