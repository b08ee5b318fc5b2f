"""Time-to-healthy of the port's server with ``WARMUP_PROGRESSIVE=1``,
against a full warmup in the same run.

The port's counterpart of ``tools/measure_progressive_boot.py``.  It boots
the real server (``python -m matcha_tpu_torch.serving.server``, the
artifacts of ``utils/live_serving_ab``) with progressive warmup,
``BATCHER_MAX_BATCH=16`` and ``WARMUP_BATCH_SIZES=1,2,4,8,16``, and
records:

  * ``healthy_s``: seconds until ``/health`` first answers 200, and
    ``health_body_at_ready``;
  * ``request_during_warm``: status, ms and bytes of one WAV request
    served while ``/health`` still says ``"warming"`` (absent when the
    ladder was done before the first 200 was seen);
  * ``fully_warm_s``: seconds until the ``warming`` flag clears.

The JAX tool compared ``healthy_s`` against full-warmup boots stored from
a TPU run; those are not the card's, so this one boots the same server a
second time with ``WARMUP_PROGRESSIVE=0`` and records its time to healthy
(``full_warmup``) and what the progressive gate saved
(``healthy_gain_s``: the full boot's healthy_s less the progressive
one's; one boot each, so boot-to-boot noise is in it).  Both boots come
after the tool has built the port's CUDA kernels in its own process.
``healthy_s <= fully_warm_s`` holds by construction (the warming flag is
polled only after the first 200), a sanity check of the report kept from
the JAX tool; that the gate opened early shows in
``health_body_at_ready["warming"]`` and in ``healthy_gain_s``.

    python -m matcha_tpu_torch.utils.measure_progressive_boot

Knobs (env): ``AB_CKPT``, ``AB_VOCOS``, ``AB_PORT`` (8902) and
``AB_HEALTH_TIMEOUT`` as in ``live_serving_ab``; ``TEXT_BUCKETS``, ``MEL_BUCKETS`` and
``SERVE_DEVICE`` pass through to the server.  Prints one JSON report and
exits 1 when a server never becomes healthy, a request during warmup is
not answered with a WAV, or healthy_s > fully_warm_s.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request

from matcha_tpu_torch.utils.live_serving_ab import (
    Settings,
    health,
    log_tail,
    prebuild_kernels,
    prepare_artifacts,
    server_env,
    start_server,
    stop_server,
    wait_health,
)

LADDER = "1,2,4,8,16"
POLL_S = 0.25  # fine enough to see the warming window of a fast ladder
WARM_IDS = [5, 17, 203, 44, 9, 310]


def speak_wav(port: int, ids=WARM_IDS, timeout: float = 600) -> dict:
    """One WAV request: status, ms, bytes and whether the body is a WAV."""
    req = urllib.request.Request(
        f"http://localhost:{port}/v1/audio/speech",
        data=json.dumps({"phoneme_ids": ids, "voice": "0", "response_format": "wav"}).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status, audio = r.status, r.read()
    return {"status": status, "ms": round((time.time() - t0) * 1000, 1), "bytes": len(audio),
            "wav": audio[:4] == b"RIFF" and audio[8:12] == b"WAVE"}


def progressive_boot(s: Settings) -> dict:
    """The progressive boot: healthy_s, the body then, a request while
    warming, fully_warm_s."""
    env = server_env(s, BATCHER_MAX_BATCH=16, WARMUP_BATCH_SIZES=LADDER, WARMUP_PROGRESSIVE=1, WARMUP_FULL=0)
    log_path = s.log_path("progressive")
    server, log = start_server(env, log_path)
    out = {}
    try:
        healthy_s, body = wait_health(s.port, s.health_timeout_s, server, poll_s=POLL_S)
        t0 = time.time() - healthy_s
        out.update(healthy_s=round(healthy_s, 2), health_body_at_ready=body)
        if body.get("warming"):  # serve a request during the warm phase
            out["request_during_warm"] = speak_wav(s.port)
        while True:  # until the warming flag clears (the whole ladder warm)
            code, body = health(s.port)
            if code == 200 and not body.get("warming"):
                out["fully_warm_s"] = round(time.time() - t0, 2)
                break
            if time.time() - t0 > s.health_timeout_s + 1800 or server.poll() is not None:
                out["fully_warm_s"] = None
                break
            time.sleep(POLL_S)
    except Exception as exc:
        out.update(error=f"{type(exc).__name__}: {exc}", server_log_tail=log_tail(log_path))
    finally:
        stop_server(server, log)
    return out


def full_warmup_boot(s: Settings) -> dict:
    """The same server with the whole ladder warmed before /health says 200."""
    env = server_env(s, BATCHER_MAX_BATCH=16, WARMUP_BATCH_SIZES=LADDER, WARMUP_PROGRESSIVE=0, WARMUP_FULL=0)
    log_path = s.log_path("full_warmup")
    server, log = start_server(env, log_path)
    try:
        healthy_s, body = wait_health(s.port, s.health_timeout_s, server, poll_s=POLL_S)
        return {"healthy_s": round(healthy_s, 2), "health_body_at_ready": body}
    except Exception as exc:
        return {"healthy_s": None, "error": f"{type(exc).__name__}: {exc}", "server_log_tail": log_tail(log_path)}
    finally:
        stop_server(server, log)


def failures(report: dict) -> list[str]:
    bad = []
    if report.get("healthy_s") is None or report.get("fully_warm_s") is None:
        bad.append(f"progressive boot: healthy_s {report.get('healthy_s')}, fully_warm_s {report.get('fully_warm_s')}"
                   f" {report.get('error', '')}")
    elif report["healthy_s"] > report["fully_warm_s"]:
        bad.append(f"healthy_s {report['healthy_s']} > fully_warm_s {report['fully_warm_s']}")
    warm = report.get("request_during_warm")
    if warm is not None and not (warm["status"] == 200 and warm["wav"]):
        bad.append(f"request during warmup: {warm}")
    if report["full_warmup"]["healthy_s"] is None:
        bad.append(f"full-warmup boot: {report['full_warmup'].get('error')}")
    return bad


def main(argv=None) -> int:
    from matcha_tpu_torch import bench

    s = Settings.from_env(default_port=8902)
    t0 = time.time()
    built, device = prebuild_kernels()  # raises without a card unless SERVE_DEVICE says otherwise
    widths = prepare_artifacts(s)
    report = progressive_boot(s)
    report["full_warmup"] = full_warmup_boot(s)
    if report.get("healthy_s") is not None and report["full_warmup"]["healthy_s"] is not None:
        report["healthy_gain_s"] = round(report["full_warmup"]["healthy_s"] - report["healthy_s"], 2)
    report.update(warmup_batch_sizes=LADDER, kernels_prebuilt=built, serve_device=str(device),
                  device=bench.device_info(device), durations=bench.DURATIONS, compute_dtype="bfloat16",
                  widths=widths, checkpoint=str(s.ckpt), health_poll_s=POLL_S)
    bad = failures(report)
    report["ok"] = not bad
    if bad:
        report["failed"] = bad
    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
