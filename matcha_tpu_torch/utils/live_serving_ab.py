"""Live serving A/B on the port's HTTP server: batcher group-size legs.

The port's counterpart of ``tools/live_serving_ab.py``.  It boots the real
server (``python -m matcha_tpu_torch.serving.server``) in a subprocess at
production width with random weights (throughput and latency are the
architecture's, whatever the weights), drives it with ``psr/load_test.py
--ids`` (the repository's standard-library load client, which sends
pretokenised ids, so no eSpeak is needed), and prints one JSON report.

    python -m matcha_tpu_torch.utils.live_serving_ab

Each leg boots a server with ``BATCHER_MAX_BATCH`` = the leg's group size,
``SERVE_FUSED`` = the leg's fused switch, ``WARMUP_BATCH_SIZES`` = the
power-of-two ladder up to the group size and ``WARMUP_FULL=0``, waits for
``/health`` (``warmup_s``), runs one load test per user count, and stops
the server with SIGTERM only once the load test has drained (a kill after
60 s).  Before the first boot the tool builds the port's CUDA kernels in
its own process, so that no leg's ``warmup_s`` holds their first build.

Knobs (env), as the JAX tool's: ``AB_LEGS`` (group sizes, 8,16),
``AB_FUSED`` (``SERVE_FUSED`` values, 0), ``AB_USERS`` (20,50,100),
``AB_MINUTES`` (2 a cell), ``AB_HEALTH_TIMEOUT`` (3600 s), ``AB_PORT``
(8901), ``AB_CKPT`` / ``AB_VOCOS`` (the artifacts, made on first use);
``TEXT_BUCKETS`` / ``MEL_BUCKETS`` pass through to the server (the load
test's ids are 20-110 tokens: ``TEXT_BUCKETS=64,128``), and so does
``SERVE_DEVICE`` (``cpu`` runs the whole tool on the CPU).  The servers'
logs go to the temporary directory.

The artifacts: a flat checkpoint (``config.json`` + ``state.npz``) of
``MatchaConfig()`` in bf16, the benchmark's operating point, with the
duration head pinned at 4 fine frames a token (``bench.pin_durations``),
and a Vocos pickle; both made on the CPU by the port, with no JAX.  At the
default paths they are made, or made again where the widths found there
differ; artifacts named by ``AB_CKPT`` are served as they are (made at
production width only where none exist).  The report's ``widths`` are
read from the served files.  The default paths differ from the JAX tool's
``/tmp/serve_ckpt``, where the JAX writer may leave an orbax directory
that the port cannot read.  A CPU rehearsal at tiny widths makes its
artifacts first with ``ensure_artifacts(ckpt, vocos, tiny=True)`` and
names them with ``AB_CKPT`` / ``AB_VOCOS``.

No hidden failure: a cell whose load test has no successful request or
any error, or a server that never becomes healthy (or exits), ends the run
with exit code 1; the report then holds the failed leg and the tail of
its server's log.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HEALTH_POLL_S = 1.0
DRAIN_S = 10.0  # idle between two cells of a leg
WIDTHS = {False: "MatchaConfig() + VocosConfig()", True: "bench tiny widths, 16 speakers"}


@dataclass
class Settings:
    """The tool's knobs, read from the environment (``Settings.from_env``)."""

    ckpt: Path
    vocos: Path
    port: int
    minutes: float
    users: tuple[int, ...]
    legs: tuple[int, ...]
    fused_legs: tuple[int, ...]
    health_timeout_s: float
    ckpt_given: bool  # AB_CKPT named the artifacts: served as they are

    @classmethod
    def from_env(cls, env=None, default_port: int = 8901) -> "Settings":
        env = os.environ if env is None else env
        tmp = Path(tempfile.gettempdir())

        def ints(name, default):
            return tuple(int(v) for v in env.get(name, default).split(","))

        return cls(
            ckpt=Path(env.get("AB_CKPT", tmp / "matcha_torch_serve_ckpt")),
            vocos=Path(env.get("AB_VOCOS", tmp / "matcha_torch_serve_vocos.pkl")),
            port=int(env.get("AB_PORT", str(default_port))),
            minutes=float(env.get("AB_MINUTES", "2")),
            users=ints("AB_USERS", "20,50,100"),
            legs=ints("AB_LEGS", "8,16"),
            # second leg dimension: SERVE_FUSED values to sweep (AB_FUSED=0,1
            # with AB_LEGS=16 measures the fused-group dispatch lever live)
            fused_legs=ints("AB_FUSED", "0"),
            health_timeout_s=float(env.get("AB_HEALTH_TIMEOUT", "3600")),
            ckpt_given="AB_CKPT" in env,
        )

    def log_path(self, name: str) -> Path:
        """A server's log, in the temporary directory, keyed by the port."""
        return Path(tempfile.gettempdir()) / f"matcha_torch_server_{self.port}_{name}.log"


class LegFailed(RuntimeError):
    """A leg that must end the run; ``leg`` is its report so far."""

    def __init__(self, msg: str, leg: dict):
        super().__init__(msg)
        self.leg = leg


def artifact_configs(tiny: bool = False):
    """(MatchaConfig, VocosConfig) of the artifacts: the benchmark's bf16
    point at production width, or its tiny widths with 16 speakers (the
    load test's voices reach speaker 13)."""
    from matcha_tpu_torch import bench

    cfg, vcfg = bench.configs("bfloat16", tiny)
    return (dataclasses.replace(cfg, n_spks=16) if tiny else cfg), vcfg


def _vocos_widths(vcfg) -> tuple:
    return vcfg.input_channels, vcfg.dim, vcfg.intermediate_dim, vcfg.num_layers, vcfg.n_fft


def read_artifact_configs(ckpt: Path, vocos: Path):
    """(MatchaConfig, VocosConfig) of the artifacts on disk, or None where
    either is missing: the checkpoint's ``config.json`` and the widths of
    the Vocos pickle's shapes, as the server reads them."""
    from matcha_tpu_torch.checkpoint import infer_vocos_config
    from matcha_tpu_torch.models.config import MatchaConfig

    ckpt, vocos = Path(ckpt), Path(vocos)
    if not ((ckpt / "config.json").exists() and (ckpt / "state.npz").exists() and vocos.exists()):
        return None
    with open(vocos, "rb") as f:
        vcfg = infer_vocos_config(pickle.load(f))
    return MatchaConfig.from_dict(json.loads((ckpt / "config.json").read_text())), vcfg


def artifact_widths(ckpt: Path, vocos: Path):
    """The served artifacts' widths: the name of one of ``artifact_configs``'
    two points, or the configs themselves."""
    cfg, vcfg = read_artifact_configs(ckpt, vocos)
    for tiny, label in WIDTHS.items():
        want, want_v = artifact_configs(tiny)
        if cfg == want and _vocos_widths(vcfg) == _vocos_widths(want_v):
            return label
    return {"matcha": cfg.to_dict(), "vocos": dataclasses.asdict(vcfg)}


def ensure_artifacts(ckpt: Path, vocos: Path, tiny: bool = False) -> None:
    """A random checkpoint (bf16, duration head pinned) and a Vocos pickle
    at ``artifact_configs(tiny)``, made on the CPU; kept where both exist
    at those widths, made again where the widths differ."""
    import torch

    from matcha_tpu_torch import bench
    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.train.checkpoint import save_tree
    from matcha_tpu_torch.vocoder.vocos import init_vocos_params
    from matcha_tpu_torch.weights import params_to_jax, vocos_params_to_jax

    ckpt, vocos = Path(ckpt), Path(vocos)
    cfg, vcfg = artifact_configs(tiny)
    found = read_artifact_configs(ckpt, vocos)
    if found is not None and found[0] == cfg and _vocos_widths(found[1]) == _vocos_widths(vcfg):
        return
    params = bench.pin_durations(init_params(cfg, torch.Generator().manual_seed(0)))
    save_tree(ckpt, {"params": params_to_jax(params, cfg)}, cfg)
    vocos.parent.mkdir(parents=True, exist_ok=True)
    with open(vocos, "wb") as f:
        pickle.dump(vocos_params_to_jax(init_vocos_params(vcfg, torch.Generator().manual_seed(1)), vcfg), f)


def prepare_artifacts(s: Settings):
    """The artifacts a run serves, and their widths: those ``AB_CKPT`` names
    as they are, else production-width ones made by ``ensure_artifacts``."""
    if not (s.ckpt_given and read_artifact_configs(s.ckpt, s.vocos) is not None):
        ensure_artifacts(s.ckpt, s.vocos)
    return artifact_widths(s.ckpt, s.vocos)


def fused_pace_matches() -> dict:
    """The server's fused bucket guess (``fused_frames_per_token`` fine
    frames per 2 ids) against the pinned head's frames a token: equal, so
    a fused group of the load test's lengths does not overflow its bucket."""
    from matcha_tpu_torch import bench
    from matcha_tpu_torch.inference import MatchaSynthesizer

    per_id = MatchaSynthesizer.fused_frames_per_token / 2
    return {"fused_frames_per_id": per_id, "pinned_frames_per_id": bench.FRAMES_PER_TOKEN,
            "match": per_id == bench.FRAMES_PER_TOKEN}


def prebuild_kernels() -> tuple[bool, "object"]:
    """Build the port's CUDA kernels here when the server will run on the
    card (``SERVE_DEVICE`` unset or a CUDA device), so that no boot holds
    their first build.  Returns (built, the server's device); raises
    without a card when the server would need one."""
    from matcha_tpu_torch.inference import resolve_device

    device = resolve_device(os.environ.get("SERVE_DEVICE") or None)
    if device.type != "cuda":
        return False, device
    from matcha_tpu_torch.ops.extension import kernels

    kernels()
    return True, device


def server_env(s: Settings, **extra) -> dict:
    """The server's environment: ours, the artifacts, the port, ``extra``,
    and the repository first on ``PYTHONPATH``."""
    return dict(
        os.environ,
        CHECKPOINT_PATH=str(s.ckpt),
        VOCODER_PATH=str(s.vocos),
        PORT=str(s.port),
        PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p),
        **{k: str(v) for k, v in extra.items()},
    )


def start_server(env: dict, log_path: Path) -> tuple[subprocess.Popen, object]:
    log_path.parent.mkdir(parents=True, exist_ok=True)
    log = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", "matcha_tpu_torch.serving.server"], env=env, cwd=str(REPO),
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def stop_server(proc: subprocess.Popen, log) -> None:
    """SIGTERM (the server drains), then a kill after 60 s."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    log.close()


def log_tail(path: Path, n: int = 3000) -> str:
    try:
        return Path(path).read_text(errors="replace")[-n:]
    except OSError:
        return ""


def health(port: int, timeout: float = 5) -> tuple[int | None, dict]:
    """(status, body) of ``/health``; (None, {}) when nothing answers."""
    try:
        with urllib.request.urlopen(f"http://localhost:{port}/health", timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return exc.code, {}
    except Exception:
        return None, {}


def wait_health(port: int, timeout_s: float, proc: subprocess.Popen | None = None,
                poll_s: float = HEALTH_POLL_S) -> tuple[float, dict]:
    """Seconds until ``/health`` first answers 200, and its body; raises if
    the server exits or the time runs out."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        code, body = health(port)
        if code == 200:
            return time.time() - t0, body
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"the server exited with {proc.returncode} before it was healthy")
        time.sleep(poll_s)
    raise TimeoutError("server never became healthy")


def parse_report(text: str) -> dict:
    """The load test's report lines → numbers (the JAX tool's regexes)."""
    out = {}
    m = re.search(r"requests: (\d+) ok, (\d+) errors", text)
    if m:
        out["ok"], out["errors"] = int(m.group(1)), int(m.group(2))
    m = re.search(r"latency p50 (\d+)ms\s+p95 (\d+)ms", text)
    if m:
        out["p50_ms"], out["p95_ms"] = int(m.group(1)), int(m.group(2))
    m = re.search(r"throughput: ([\d.]+) req/s", text)
    if m:
        out["req_per_s"] = float(m.group(1))
    m = re.search(r"service RTF ([\d.]+)", text)
    if m:
        out["service_rtf"] = float(m.group(1))
    return out


def cell_failure(text: str, cell: dict) -> str | None:
    """Why a load-test cell fails the run, or None: no successful request,
    any error, or no report at all."""
    if "no successful requests" in text:
        return "no successful requests"
    if "ok" not in cell or "p50_ms" not in cell:
        return "no load-test report"
    if cell["ok"] <= 0:
        return "no successful requests"
    if cell["errors"] > 0:
        return f"{cell['errors']} errors"
    return None


def ladder(max_batch: int) -> str:
    """The power-of-two warmup ladder up to ``max_batch``: 1,2,4,...,max_batch."""
    return ",".join(str(1 << i) for i in range(max_batch.bit_length()))


def run_leg(max_batch: int, fused: int, s: Settings) -> dict:
    """One server boot, one load test per user count.  Raises ``LegFailed``
    (with the leg and its server log's tail) on a failed cell or a server
    that never becomes healthy."""
    env = server_env(s, SERVE_FUSED=fused, BATCHER_MAX_BATCH=max_batch, WARMUP_BATCH_SIZES=ladder(max_batch),
                     WARMUP_FULL="0")
    log_path = s.log_path(f"ab_b{max_batch}_f{fused}")
    server, log = start_server(env, log_path)
    leg = {"max_batch": max_batch, "fused": fused, "warmup_batch_sizes": env["WARMUP_BATCH_SIZES"]}
    failure = None
    try:
        try:
            leg["warmup_s"] = round(wait_health(s.port, s.health_timeout_s, server)[0], 1)
        except (RuntimeError, TimeoutError) as exc:
            failure = str(exc)
        for i, users in enumerate(s.users if failure is None else ()):
            if i:
                time.sleep(DRAIN_S)  # drain fully between cells
            proc = subprocess.run(
                [sys.executable, "psr/load_test.py", "--host", f"http://localhost:{s.port}", "--users", str(users),
                 "--minutes", str(s.minutes), "--ids"],
                capture_output=True, text=True, cwd=str(REPO), timeout=s.minutes * 60 + 300,
            )
            cell = parse_report(proc.stdout)
            failure = cell_failure(proc.stdout, cell)
            if failure:
                cell.update(raw=proc.stdout[-400:], err=proc.stderr[-400:])
            leg[f"users_{users}"] = cell
            print(f"  b={max_batch} fused={fused} users={users}: {cell}", file=sys.stderr)
            if failure:
                failure = f"users={users}: {failure}"
                break
    finally:
        # the server is idle now (load test joined, drained): a SIGTERM here
        # interrupts no request in flight
        stop_server(server, log)
    if failure:
        leg.update(failed=failure, server_log_tail=log_tail(log_path))
        raise LegFailed(f"leg max_batch={max_batch} fused={fused}: {failure}", leg)
    return leg


def main(argv=None) -> int:
    from matcha_tpu_torch import bench

    s = Settings.from_env()
    t0 = time.time()
    built, device = prebuild_kernels()  # raises without a card unless SERVE_DEVICE says otherwise
    pace = fused_pace_matches()
    if not pace["match"]:
        raise RuntimeError(f"fused bucket guess and the pinned head disagree: {pace}")
    widths = prepare_artifacts(s)
    report = {"minutes_per_cell": s.minutes, "users": list(s.users), "legs": [],
              "kernels_prebuilt": built, "serve_device": str(device), "device": bench.device_info(device),
              "compute_dtype": "bfloat16", "widths": widths, "checkpoint": str(s.ckpt),
              "durations": bench.DURATIONS, "fused_pace": pace, "weights": "random (torch.Generator seeds 0 and 1)",
              "text_buckets": os.environ.get("TEXT_BUCKETS", "server default"),
              "mel_buckets": os.environ.get("MEL_BUCKETS", "server default")}
    rc = 0
    try:
        for b in s.legs:
            for f in s.fused_legs:
                print(f"=== leg max_batch={b} fused={f} ===", file=sys.stderr)
                report["legs"].append(run_leg(b, f, s))
    except LegFailed as exc:
        report["legs"].append(exc.leg)
        report["failed"] = str(exc)
        rc = 1
    report["ok"] = rc == 0
    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
