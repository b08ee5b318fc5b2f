"""The port's chip A/B tools against the JAX system's on the CPU.

``matcha_tpu_torch/utils/ab_fast_solvers.py`` against
``tools/ab_fast_solvers.py`` and ``utils/ab_stage_b_levers.py`` against
``tools/ab_stage_b_levers.py``, at ``tiny_config()`` widths and a small
operating point (the JAX tools' module constants B, TX, Y_FINE_LEN
monkeypatched to 2, 32, 128): JAX ``init_params`` weights bridged into
the port, the duration head pinned at 4 fine frames a token on the port's
state and carried back to the JAX tree through ``weights.params_to_jax``,
so both fill the bucket.  On the CPU the port's attention is K1's plain
version and the probe runs its chain eagerly.

Tolerances:
  * solver mels, fp32: max |port − JAX| ≤ 1e-4 · max |JAX| at every point;
  * MCD against midpoint/4: the port's reading within 1e-3 dB of the JAX
    tier's ``mel_mcd_db`` on the JAX mels;
  * levers a and c, bf16: the rule of ``tests/test_torch_decoder_variants.py``:
    the variant's mel may differ from the JAX package's by at most twice
    what the baseline differs by (bf16 rounds at other points in XLA), in
    the tools' own distance, mel MCD, and for lever a also in max |Δ| /
    max |mel|.  Lever c's all-bf16 carry makes every program more
    sensitive to where it rounds, the JAX package's own included: the
    same JAX program compiled without XLA's fusion passes and with excess
    precision off (every op rounds its output to its dtype, the residual
    adds included) stands about twice as far from the fused one with the
    carry in bf16 as with it in fp32, and so does the port (max |Δ| /
    max |mel| 0.0070 against 0.0033 for JAX, 0.0074 against 0.0032 for
    the port, at this file's point).  So lever c's max |Δ| is held, in
    each regime, to twice that spread of the JAX package against itself;
    besides, its MCD by the rule above and its distance to the JAX fp32
    mel.  These bf16 bars catch a switch that is a no-op or wired wrongly,
    not which of two neighbouring points rounds: the rounding noise of
    bf16 at these widths is as large as such a choice;
  * lever b, fp32: both layouts within 1e-5 · max |ref| of
    ``lax.conv_general_dilated`` with the decoder's explicit padding.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch import bench
from matcha_tpu_torch.inference import MatchaSynthesizer
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.utils import ab_fast_solvers as ab
from matcha_tpu_torch.utils import ab_stage_b_levers as lv
from matcha_tpu_torch.vocoder.vocos import VocosConfig
from matcha_tpu_torch.weights import params_from_jax, params_to_jax, vocos_params_from_jax

# the JAX tools set a persistent compilation cache when imported: keep this
# process's settings
_CACHE = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
import tools.ab_fast_solvers as jax_fast  # noqa: E402
import tools.ab_stage_b_levers as jax_levers  # noqa: E402
from tests.test_tpu_e2e import mel_mcd_db as jax_mel_mcd_db  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _CACHE[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", _CACHE[1])

B, TX, FINE = 2, 32, 128
WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
BUCKETS = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256))


@pytest.fixture(autouse=True)
def small_point(monkeypatch):
    for mod in (jax_fast, jax_levers):
        monkeypatch.setattr(mod, "B", B)
        monkeypatch.setattr(mod, "TX", TX)
        monkeypatch.setattr(mod, "Y_FINE_LEN", FINE)


@pytest.fixture(scope="module")
def weights():
    """(JAX tree, port state, JAX Vocos tree): JAX init, bridged, the port's
    duration head pinned and carried back to the JAX tree."""
    jcfg, jvcfg = jax_tiny_config(), JaxVocosConfig(**WIDTHS)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_params(jcfg, k))(jax.random.PRNGKey(0)))
    state = bench.pin_durations(params_from_jax(params, tiny_config()))
    vparams = jax.tree.map(np.asarray, jax.jit(lambda k: init_vocos_params(k, jvcfg))(jax.random.PRNGKey(1)))
    return jax.tree.map(np.asarray, params_to_jax(state, tiny_config())), state, vparams


def pair(weights, dtype="float32", **switches):
    """(JAX synthesizer, port synthesizer) on the pinned weights at ``dtype``
    with the levers' switches."""
    jparams, state, vparams = weights
    jcfg = lv.lever_config(dataclasses.replace(jax_tiny_config(), compute_dtype=dtype), **switches)
    pcfg = lv.lever_config(dataclasses.replace(tiny_config(), compute_dtype=dtype), **switches)
    jvcfg, pvcfg = JaxVocosConfig(compute_dtype=dtype, **WIDTHS), VocosConfig(compute_dtype=dtype, **WIDTHS)
    ref = JaxSynthesizer(jcfg, jparams, vparams, jvcfg, **BUCKETS)
    port = MatchaSynthesizer(pcfg, state, vocos_params_from_jax(vparams, pvcfg), pvcfg, device="cpu", **BUCKETS)
    return ref, port


@pytest.fixture(scope="module")
def fp32_pair(weights):
    return pair(weights)


_JAX_MELS = {}


def jax_mel(ref, solver, steps):
    key = (solver, steps)
    if key not in _JAX_MELS:
        _JAX_MELS[key] = jax_fast.decode_mel(ref, jax_fast.stage_b_inputs(ref), solver, steps)
    return _JAX_MELS[key]


def test_stage_b_inputs_equal_the_jax_tools(fp32_pair):
    """The same ids, stage A's durations and totals; pinned, the bucket is full."""
    ref, port = fp32_pair
    mu_x, durations, x_mask, totals = jax_fast.stage_b_inputs(ref)
    p_mu, p_dur, p_mask, p_totals = ab.stage_b_inputs(port, B, TX, FINE)
    np.testing.assert_array_equal(p_dur.numpy(), np.asarray(durations))
    np.testing.assert_array_equal(p_totals.numpy(), np.asarray(totals))
    np.testing.assert_allclose(p_mu.numpy(), np.asarray(mu_x), rtol=1e-5, atol=1e-6)
    assert np.all(p_totals.numpy() == FINE)


@pytest.mark.parametrize("solver,steps", ab.POINTS, ids=[f"{s}{n}" for s, n in ab.POINTS])
def test_solver_mel_matches_jax_tool(fp32_pair, solver, steps):
    ref, port = fp32_pair
    want = jax_mel(ref, solver, steps)
    got = ab.decode_mel(port, ab.stage_b_inputs(port, B, TX, FINE), solver, steps, FINE)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_mcd_vs_midpoint4_matches_jax_tier(fp32_pair):
    """``measure_points``' MCDs against ``tests.test_tpu_e2e.mel_mcd_db`` on
    the JAX tool's mels; midpoint/4 against itself reads 0 (CPU decodes
    are deterministic); the CPU time is not named a device time."""
    ref, port = fp32_pair
    points = ab.measure_points(port, ab.stage_b_inputs(port, B, TX, FINE), FINE, k=2, reps=1)
    ref_mel = jax_mel(ref, *ab.REFERENCE)
    for solver, steps in ab.POINTS:
        p = points[f"{solver}/{steps}"]
        assert abs(p["mel_mcd_vs_midpoint4_db"] - jax_mel_mcd_db(ref_mel, jax_mel(ref, solver, steps))) <= 1e-3
        assert p["unet_evals"] == steps * (2 if solver == "midpoint" else 1)
        assert p["device_ms"] is None and p["cpu_ms"] > 0
    assert points["midpoint/4"]["mel_mcd_vs_midpoint4_db"] == 0.0
    assert ab.check_report(points) == []


UNFUSED_XLA_FLAGS = ("--xla_disable_hlo_passes=cpu-instruction-fusion,fusion,cpu-parallel-task-assigner "
                     "--xla_allow_excess_precision=false")
UNFUSED_SCRIPT = """
import sys
import numpy as np
import tests.test_torch_ab_tools as t
for mod in (t.jax_fast, t.jax_levers):
    mod.B, mod.TX, mod.Y_FINE_LEN = t.B, t.TX, t.FINE
w = t.weights.__wrapped__()
mels = {}
for name, kw in (("baseline", {}), ("variant", {"fp32_residual": False})):
    ref, _ = t.pair(w, "bfloat16", **kw)
    mels[name] = t.jax_levers.decode_mel(ref, t.jax_levers.stage_b_inputs(ref))
np.savez(sys.argv[1], **mels)
"""


def start_jax_unfused_lever_c_mels(out):
    """The JAX tool's baseline and bf16-carry mels from the same program
    compiled without XLA's fusion passes and with excess precision off,
    written to ``out`` by a subprocess (XLA reads its flags once, at
    start), its output to ``out``.log; returns the process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, XLA_FLAGS=UNFUSED_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p))
    with open(f"{out}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", UNFUSED_SCRIPT, str(out)], cwd=str(root), env=env,
                                stdout=log, stderr=subprocess.STDOUT)


@pytest.mark.parametrize("lever,switches", [("a", {"bf16_norm_stats": True}), ("c", {"fp32_residual": False})])
def test_lever_variant_mel_matches_jax(weights, lever, switches, tmp_path):
    """bf16: the variant's mel drifts from the JAX package's no further than
    twice the baseline does (``test_torch_decoder_variants.py``'s rule; for
    lever c's max |Δ|, twice the JAX package's own spread between its fused
    and unfused compilations), and the switch moves the mel on both sides."""
    from matcha_tpu_torch.utils.hw_parity import mel_mcd_db

    if lever == "c":  # runs while this process decodes
        unfused_proc = start_jax_unfused_lever_c_mels(tmp_path / "unfused.npz")
    errs, mcds, mels = {}, {}, {}
    for name, kw in (("baseline", {}), ("variant", switches)):
        ref, port = pair(weights, "bfloat16", **kw)
        want = jax_levers.decode_mel(ref, jax_levers.stage_b_inputs(ref))
        got = ab.decode_mel(port, ab.stage_b_inputs(port, B, TX, FINE), "midpoint", 4, FINE)
        errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
        mcds[name] = mel_mcd_db(want, got)
        mels[name] = (want, got)
    assert mcds["variant"] <= 2 * max(mcds["baseline"], 0.05), mcds
    if lever == "a":
        assert errs["variant"] <= 2 * max(errs["baseline"], 1e-3), errs
    else:
        assert unfused_proc.wait(timeout=600) == 0, (tmp_path / "unfused.npz.log").read_text()[-2000:]
        with np.load(tmp_path / "unfused.npz") as f:
            unfused = {k: f[k] for k in f.files}
        spread = {name: float(np.abs(unfused[name] - mels[name][0]).max() / np.abs(mels[name][0]).max())
                  for name in mels}
        for name in mels:
            assert errs[name] <= 2 * spread[name], (errs, spread)
        # as faithful to the fp32 mel as the JAX package's own bf16 carry
        ref, _ = pair(weights, "float32")
        exact = jax_levers.decode_mel(ref, jax_levers.stage_b_inputs(ref))
        port_gap, jax_gap = mel_mcd_db(exact, mels["variant"][1]), mel_mcd_db(exact, mels["variant"][0])
        assert port_gap <= jax_gap + mcds["baseline"], (port_gap, jax_gap, mcds)
    assert np.abs(mels["variant"][0] - mels["baseline"][0]).max() > 0
    assert np.abs(mels["variant"][1] - mels["baseline"][1]).max() > 0


def test_levers_a_and_c_report_on_the_cpu(weights):
    """``lever_a`` / ``lever_c`` building from bridged weights: the JAX
    tool's keys, CPU times under their own names, and an MCD > 0 equal to
    the one of the two mels."""
    from matcha_tpu_torch.utils.hw_parity import mel_mcd_db

    def build(**kw):
        return pair(weights, "bfloat16", **kw)[1]

    a = lv.lever_a(build, (B, TX, FINE), k=2, reps=1)
    c = lv.lever_c(build, (B, TX, FINE), k=2, reps=1)
    assert {"baseline_device_ms", "bf16_stats_device_ms", "delta_ms", "mel_mcd_vs_baseline_db"} <= set(a)
    assert {"fp32_carry_device_ms", "bf16_carry_device_ms", "delta_ms", "mel_mcd_carry_gap_db"} <= set(c)
    assert a["baseline_device_ms"] is None and a["baseline_cpu_ms"] > 0
    mels = [ab.decode_mel(build(**kw), ab.stage_b_inputs(build(), B, TX, FINE), "midpoint", 4, FINE)
            for kw in ({}, {"bf16_norm_stats": True})]
    assert a["mel_mcd_vs_baseline_db"] == round(mel_mcd_db(*mels), 4) > 0
    assert c["mel_mcd_carry_gap_db"] > 0


SMALL_CASES = [(name, t // 16, c // 40, o // 40, k, s) for name, t, c, o, k, s in lv.CONV_CASES]


@pytest.mark.parametrize("case", SMALL_CASES, ids=[c[0] for c in SMALL_CASES])
def test_conv_layouts_match_lax_conv(case):
    """fp32: the port's Conv1d on (B, T, C) and ``F.conv1d`` on contiguous
    (B, C, T) both equal ``lax.conv_general_dilated`` with the decoder's
    explicit padding (1, 1), bias added."""
    _, t, cin, cout, kernel, stride = case
    x, conv, x_ncw, ncw = lv.conv_case(B, t, cin, cout, kernel, stride, torch.float32)
    w_hio = conv.weight.detach().permute(2, 1, 0).numpy()
    want = np.asarray(lax.conv_general_dilated(jnp.asarray(x.numpy()), jnp.asarray(w_hio), (stride,), ((1, 1),),
                                               dimension_numbers=("NHC", "HIO", "NHC")))
    want = want + conv.bias.detach().numpy()
    with torch.no_grad():
        nwc_out, ncw_out = conv(x).numpy(), ncw(x_ncw).transpose(1, 2).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(nwc_out, want, rtol=0, atol=tol)
    np.testing.assert_allclose(ncw_out, want, rtol=0, atol=tol)
    assert lv.layout_rel_diff(torch.from_numpy(nwc_out), torch.from_numpy(ncw_out).transpose(1, 2)) <= 1e-5


def test_stride2_case_pads_like_the_decoder_not_same():
    """The trap of the JAX tool's down_conv3_s2 case: "SAME" at stride 2
    pads (0, 1), the decoder's Downsample1D (1, 1); the outputs differ."""
    _, t, cin, cout, kernel, stride = SMALL_CASES[2]
    x, conv, _, _ = lv.conv_case(B, t, cin, cout, kernel, stride, torch.float32)
    w_hio = jnp.asarray(conv.weight.detach().permute(2, 1, 0).numpy())
    same = np.asarray(lax.conv_general_dilated(jnp.asarray(x.numpy()), w_hio, (2,), "SAME",
                                               dimension_numbers=("NHC", "HIO", "NHC")))
    with torch.no_grad():
        ours = conv(x).numpy() - conv.bias.detach().numpy()
    assert ours.shape == same.shape == (B, t // 2, cout)
    assert np.abs(ours - same).max() > 1e-3


def test_conv_bound_of_the_production_body_conv():
    """2 · 16 · 512 · 320 · 320 · 3 = 5.03 GFLOP at 989 TF/s: 5.09 µs, above
    the bytes' 3.3 µs."""
    bound, by = lv.conv_bound(16, 512, 320, 320, 3, 1)
    assert by == "operations"
    assert bound == pytest.approx(2 * 16 * 512 * 320 * 320 * 3 / 989e12 * 1e3)
    assert 0.0050 < bound < 0.0052


def test_fast_solvers_cli_on_the_cpu(capsys):
    """``python -m matcha_tpu_torch.utils.ab_fast_solvers --device cpu
    --tiny``: one JSON report with the JAX tool's keys, durations and the
    device, exit 0."""
    assert ab.main(["--device", "cpu", "--tiny"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert {"backend", "operating_point", "reference_point", "points", "wall_s", "durations", "device"} <= set(report)
    assert report["durations"] == bench.DURATIONS and report["device"]["platform"] == "cpu"
    assert list(report["points"]) == [f"{s}/{n}" for s, n in ab.POINTS]
    assert report["totals"] == [TX * bench.FRAMES_PER_TOKEN] * 2


def test_levers_cli_on_the_cpu(capsys):
    assert lv.main(["--device", "cpu", "--tiny"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert {"backend", "operating_point", "lever_a_bf16_norm_stats", "lever_b_conv_layout",
            "lever_c_fp32_carry_cost", "wall_s", "durations", "device"} <= set(report)
    assert set(report["lever_b_conv_layout"]) == {c[0] for c in lv.CONV_CASES}
    assert "padding_note" in report["lever_b_conv_layout"]["down_conv3_s2_c320_t512"]
    assert lv.check_report(report) == []


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (ab.main, lv.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
