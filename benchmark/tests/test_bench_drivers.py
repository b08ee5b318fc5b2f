"""Each driver at tiny widths on the CPU, the harness's look for a chip
skipped: the result line's keys, and ``correct`` coming out false when the
timed path is broken underneath."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _check_line(result, cell, trace=False):
    assert list(result)[: len(KEYS)] == list(KEYS) and list(result)[-1] == "checks"
    json.loads(json.dumps(result))
    want = {m["name"] for m in harness.cell_metrics(harness.spec(), cell, trace)}
    assert set(result["metrics"]) <= want
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}, name


@pytest.mark.parametrize("cell", ["v20-serve-poisson", "v20-serve-single", "v20-serve-bulk", "base-train"])
def test_driver_runs_and_is_correct(cell):
    result, run, loaded = tiny.run(cell)
    _check_line(result, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert not loaded
    e2e = {m["name"] for m in harness.cell_metrics(harness.spec(), cell, False)}
    assert set(result["metrics"]) == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_an_answer_altered_where_produced_is_not_correct():
    def swap_rows(id_lists, results):
        for r in results:  # every row's audio reversed in time
            r.wav = np.ascontiguousarray(r.wav[::-1])
        return results

    result, _, _ = tiny.run("v20-serve-single", fault=swap_rows)
    assert not result["correct"]
    assert result["checks"]["audio_rel_err"]["value"] > result["checks"]["audio_rel_err"]["limit"]


def test_a_request_that_fails_is_not_correct():
    def fail(id_lists, results):
        raise RuntimeError("group failed")

    result, _, _ = tiny.run("v20-serve-poisson", fault=fail)
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault):
    result, _, _ = tiny.run("base-train", fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["v20-serve-single", "base-train"])
def test_the_fp8_control_is_not_correct(cell):
    """The reference computed in fp8 in the program's place reads past a
    limit the program's own runs keep."""
    result, run, _ = tiny.run(cell, control=True)
    limits = harness.cell(cell)["limits"]
    if "control" in run.extra:
        assert any(run.extra["control"][k] > limits[k] for k in run.extra["control"])
    else:
        assert run.extra["control_audio_rel_err"] > limits["audio_rel_err"]


def test_a_traced_run_reports_per_layer_metrics():
    result, run, _ = tiny.run("base-train", seconds=3.0, trace=True)
    _check_line(result, "base-train", trace=True)
    assert "breakdown" in result and result["device"]["window_s"] > 0
    assert {"pad_share.train", "batch_wait_ms.train", "mfu.train"} <= set(result["metrics"])
