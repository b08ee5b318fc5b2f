"""The end-to-end arithmetic and the readers: percentiles over all
requests (failures counted as missing), rates over the whole window,
which metrics a cell reports, and the roofline arithmetic."""

import types

import numpy as np
import pytest

from benchmark import harness, readings, roofline


def _run(**kw):
    run = harness.Run(cell="c", seed=1, seconds=10.0, trace=False, cfg={}, mix={}, device=None)
    run.t0, run.window_s = 100.0, 10.0
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _req(due, lat, ok=True, audio=1.0):
    return {"due": due, "done": due + lat, "ok": ok, "audio_s": audio, "n": 10}


def test_latency_percentiles_take_every_request_of_the_window():
    reqs = [_req(100 + i * 0.1, 0.1 * (i + 1)) for i in range(100)]
    reqs.append(_req(99.0, 50.0))  # due before the window: not counted
    run = _run(requests=reqs)
    assert readings.latency_ms(run, 50) == pytest.approx(np.percentile([100 * (i + 1) for i in range(100)], 50))
    assert readings.latency_ms(run, 95) == pytest.approx(9505.0)


def test_a_failed_or_missing_request_counts_as_missing_every_limit():
    reqs = [_req(100 + i, 0.2) for i in range(9)] + [_req(109.5, 0.2, ok=False)]
    run = _run(requests=reqs)
    run.extra["attempted"] = 11  # one never returned
    worst = (run.window_s + readings.MISSING_AFTER_S) * 1e3
    assert readings.latency_ms(run, 95) == pytest.approx(worst)
    assert readings.latency_ms(run, 50) == pytest.approx(200.0)


def test_rates_are_over_the_whole_window_and_only_what_completed_in_it():
    reqs = [_req(100 + i, 0.5, audio=2.0) for i in range(10)]  # the last completes at 109.5
    reqs.append(_req(109.8, 1.0, audio=5.0))  # completes after the window
    run = _run(requests=reqs)
    assert readings.audio_s_per_s(run) == pytest.approx(20.0 / 10.0)


def test_training_frames_pad_share_and_waits():
    steps = [{"rows": 4, "ty": 100, "wait_s": 0.002, "x_lengths": np.array([40, 30, 20, 40]),
              "y_lengths": np.array([90, 80, 50, 90]), "real": np.array([True, True, True, False])}]
    run = _run(steps=steps * 2)
    assert readings.train_frames_per_s(run) == pytest.approx(2 * 220 / 10.0)
    assert readings.pad_share(run) == pytest.approx(100 * (1 - 440 / 800))
    assert readings.batch_wait_ms(run) == pytest.approx(2.0)


def test_idle_share_and_group_readings():
    run = _run(group_calls=[(101.0, 101.2, 2), (102.0, 102.4, 4), (95.0, 95.1, 16)])
    run.traced = {"busy_s": 1.0, "window_s": 4.0}
    assert readings.idle_share(run) == pytest.approx(75.0)
    assert readings.group_rows(run) == pytest.approx(3.0)
    assert readings.group_call_ms(run, 50) == pytest.approx(300.0)


def test_readers_find_nothing_and_say_so():
    run = _run()
    assert readings.group_rows(run) is None and readings.idle_share(run) is None
    assert roofline.share(None, ("fwd",)) is None
    assert roofline.share({"launches": [], "kernels": {}}, ("fwd",)) is None


def test_roofline_counts_valid_keys_and_reads_kernel_time_by_name():
    import torch

    mask = torch.zeros((2, 128), dtype=torch.uint8)
    mask[0, :128] = 1
    mask[1, :64] = 1
    launch = ("fwd", (2, 6, 128, 64), "bfloat16", False, mask)
    bound = roofline.launch_bound_s(launch)
    flops = 4 * 6 * 128 * 64 * (128 + 64)
    nbytes = 4 * 2 * 6 * 128 * 64 * 2 + 2 * 128
    assert bound == pytest.approx(max(flops / harness.PEAK_BF16_FLOPS, nbytes / harness.PEAK_BYTES))
    traced = {"launches": [launch], "kernels": {"void masked_attention_fwd_bf16_wgmma_kernel<1, 2>(...)":
                                                {"s": 2 * bound, "count": 1}, "other": {"s": 1.0, "count": 3}}}
    assert roofline.share(traced, ("fwd",)) == pytest.approx(50.0)


def test_cells_report_the_metrics_benchmark_json_lists():
    bench = harness.spec()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, w["name"], False)}
        per_layer = harness.cell_metrics(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_file_is_found_by_its_name():
    bench = harness.spec()
    for w in bench["workloads"]:
        cell = harness.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        mix = harness.mix(cell["traffic"])
        assert hasattr(harness.driver(mix["driver"]), "Driver")
    for c in bench["configs"]:
        assert harness.config(c["name"])["reduced"] == c["reduced"]


def test_percentile_is_numpy_linear():
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
    assert types.FunctionType is type(harness.percentile)
