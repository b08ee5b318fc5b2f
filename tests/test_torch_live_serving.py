"""The port's live-serving tools on the CPU: ``utils/live_serving_ab.py`` and
``utils/measure_progressive_boot.py``, and the server's ``SERVE_DEVICE``.

The real server (``python -m matcha_tpu_torch.serving.server``) runs in a
subprocess with ``SERVE_DEVICE=cpu`` on a tiny-width checkpoint made by
``ensure_artifacts``, driven by the repository's ``psr/load_test.py --ids``
for about 5 s; text buckets 64,128 (the load test's ids are 20-110
tokens).  ``parse_report`` is held on the load test's own output, including
"no successful requests", which fails the leg.  Without ``SERVE_DEVICE``
the server still asks for the card and raises where there is none.
"""

import json
import math
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu_torch import bench
from matcha_tpu_torch.utils import live_serving_ab as live
from matcha_tpu_torch.utils import measure_progressive_boot as boot

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("live")
    ckpt, vocos = d / "ckpt", d / "vocos.pkl"
    live.ensure_artifacts(ckpt, vocos, tiny=True)
    return ckpt, vocos


@pytest.fixture
def cpu_server_env(monkeypatch, artifacts, tmp_path):
    """The knobs of a CPU run at tiny width: the tools read them from the
    environment and pass them on to the server."""
    ckpt, vocos = artifacts
    for k, v in {"SERVE_DEVICE": "cpu", "OMP_NUM_THREADS": "2", "TEXT_BUCKETS": "64,128",
                 "AB_CKPT": str(ckpt), "AB_VOCOS": str(vocos), "AB_PORT": str(free_port()),
                 "AB_HEALTH_TIMEOUT": "120"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(live.tempfile, "tempdir", str(tmp_path))  # the servers' logs


def load_test_output(*args) -> str:
    return subprocess.run([sys.executable, "psr/load_test.py", *args], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=60).stdout


def test_parse_report_reads_the_load_tests_lines():
    text = ("requests: 252 ok, 0 errors in 20s\n"
            "latency p50 590ms  p95 1015ms  max 1200ms\n"
            "audio generated: 120.3s  (service RTF 0.565)\n"
            "throughput: 12.49 req/s,  max concurrency 9\n")
    cell = live.parse_report(text)
    assert cell == {"ok": 252, "errors": 0, "p50_ms": 590, "p95_ms": 1015, "req_per_s": 12.49, "service_rtf": 0.565}
    assert live.cell_failure(text, cell) is None
    errors = text.replace("0 errors", "3 errors")
    assert live.cell_failure(errors, live.parse_report(errors)) == "3 errors"
    assert live.cell_failure("", {}) == "no load-test report"


def test_no_successful_requests_fails_the_leg():
    """The load test against a port where nothing listens prints "no
    successful requests"; the leg fails on it."""
    text = load_test_output("--host", f"http://localhost:{free_port()}", "--users", "1", "--minutes", "0.01",
                            "--ids")
    assert "no successful requests" in text
    assert live.cell_failure(text, live.parse_report(text)) == "no successful requests"


def test_ensure_artifacts_writes_a_checkpoint_the_port_serves(artifacts):
    """A flat checkpoint (bf16, head pinned at 4 fine frames a token) and a
    Vocos pickle that ``load_synthesizer(device="cpu")`` serves; a second
    call keeps them."""
    from matcha_tpu_torch.checkpoint import load_synthesizer

    ckpt, vocos = artifacts
    assert (ckpt / "config.json").exists() and (ckpt / "state.npz").exists() and not (ckpt / "state").exists()
    stamp = (ckpt / "state.npz").stat().st_mtime_ns
    live.ensure_artifacts(ckpt, vocos, tiny=True)
    assert (ckpt / "state.npz").stat().st_mtime_ns == stamp
    synth = load_synthesizer(str(ckpt), str(vocos), device="cpu", text_buckets=(64, 128))
    assert synth.cfg.compute_dtype == "bfloat16" and synth.cfg.n_spks == 16
    ids = list(range(1, 41))
    res = synth.synthesise_ids(ids, speaker=15, debug=True)
    np.testing.assert_array_equal(res.durations, bench.FRAMES_PER_TOKEN)
    assert np.isfinite(res.wav).all() and len(res.wav) > 0


def test_artifacts_are_made_again_where_the_widths_differ(artifacts, tmp_path):
    """``ensure_artifacts`` compares the widths on disk with those asked
    for and makes the artifacts again on a mismatch; ``artifact_widths``
    names what is served."""
    import json
    import shutil

    ckpt, vocos = tmp_path / "ckpt", tmp_path / "vocos.pkl"
    shutil.copytree(artifacts[0], ckpt)
    shutil.copy(artifacts[1], vocos)
    assert live.artifact_widths(ckpt, vocos) == live.WIDTHS[True]
    cfg = json.loads((ckpt / "config.json").read_text())
    (ckpt / "config.json").write_text(json.dumps(dict(cfg, n_spks=8)))
    assert isinstance(live.artifact_widths(ckpt, vocos), dict)
    live.ensure_artifacts(ckpt, vocos, tiny=True)
    assert json.loads((ckpt / "config.json").read_text()) == cfg
    assert live.artifact_widths(ckpt, vocos) == live.WIDTHS[True]


def test_default_artifacts_do_not_collide_with_the_jax_tools():
    s = live.Settings.from_env({})
    assert s.ckpt.name != "serve_ckpt" and s.vocos.name != "serve_vocos.pkl" and not s.ckpt_given
    assert live.Settings.from_env({"AB_CKPT": "x"}).ckpt_given
    assert (s.port, s.minutes, s.users, s.legs, s.fused_legs, s.health_timeout_s) == (
        8901, 2.0, (20, 50, 100), (8, 16), (0,), 3600.0)
    assert live.Settings.from_env({}, default_port=8902).port == 8902


def test_fused_bucket_guess_matches_the_pinned_head():
    """8 fine frames per 2 ids is the pinned 4 a token: fused groups of the
    load test's lengths stay in their bucket."""
    pace = live.fused_pace_matches()
    assert pace["match"] and pace["fused_frames_per_id"] == bench.FRAMES_PER_TOKEN
    assert live.ladder(16) == "1,2,4,8,16" and live.ladder(8) == "1,2,4,8"


def test_one_live_leg_on_the_cpu(cpu_server_env):
    """One leg of the real server (fused groups of up to 2) under 2 users for
    5 s: requests answered, no error, finite latencies."""
    s = live.Settings.from_env()
    s.minutes, s.users = 5 / 60, (2,)
    leg = live.run_leg(2, 1, s)
    cell = leg["users_2"]
    assert cell["ok"] > 0 and cell["errors"] == 0, leg
    assert math.isfinite(cell["p50_ms"]) and math.isfinite(cell["p95_ms"]) and leg["warmup_s"] > 0
    assert leg["warmup_batch_sizes"] == "1,2"


def test_a_server_that_never_becomes_healthy_fails_the_run(cpu_server_env, monkeypatch, capsys):
    """A server that exits at start (here: an unreadable TEXT_BUCKETS) ends
    the run with exit 1 and its log's tail in the report."""
    monkeypatch.setenv("TEXT_BUCKETS", "not-a-number")
    monkeypatch.setenv("AB_LEGS", "2")
    monkeypatch.setenv("AB_USERS", "2")
    assert live.main([]) == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"] and "exited" in report["failed"]
    assert "ValueError" in report["legs"][0]["server_log_tail"]
    assert report["kernels_prebuilt"] is False and report["durations"] == bench.DURATIONS
    assert report["widths"] == live.WIDTHS[True]  # read from the served files, not asked for


def test_progressive_boot_on_the_cpu(cpu_server_env, capsys):
    """Progressive warmup: healthy no later than fully warm; a request
    served while warming (if the window was seen) is a WAV; the
    full-warmup boot's time to healthy is recorded."""
    assert boot.main([]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["healthy_s"] <= report["fully_warm_s"]
    assert report["health_body_at_ready"]["status"] == "ok"
    warm = report.get("request_during_warm")
    assert warm is None or (warm["status"] == 200 and warm["wav"] and warm["bytes"] > 44)
    assert report["full_warmup"]["healthy_s"] > 0 and report["widths"] == live.WIDTHS[True]
    assert report["healthy_gain_s"] == round(report["full_warmup"]["healthy_s"] - report["healthy_s"], 2)
    assert report["warmup_batch_sizes"] == "1,2,4,8,16" and report["device"]["platform"] == "cpu"


def test_server_without_serve_device_raises_without_a_card(monkeypatch, artifacts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from matcha_tpu_torch.serving import server

    ckpt, vocos = artifacts
    monkeypatch.delenv("SERVE_DEVICE", raising=False)
    monkeypatch.setenv("CHECKPOINT_PATH", str(ckpt))
    monkeypatch.setenv("VOCODER_PATH", str(vocos))
    with pytest.raises(RuntimeError, match="CUDA"):
        server.main()


def test_tools_ask_for_the_card_without_serve_device(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("SERVE_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        live.prebuild_kernels()
    monkeypatch.setenv("SERVE_DEVICE", "cpu")
    assert live.prebuild_kernels() == (False, torch.device("cpu"))
