"""The hardware parity tier on the card: the port's full production graph
against the JAX package's CPU fp32 oracle.

The port's counterpart of ``tests/test_tpu_e2e.py``.  Full width
(``MatchaConfig()`` + ``VocosConfig()``), the weights of
``utils/hw_parity.draw_weights`` (fingerprints asserted against the
oracle's), the inputs read from ``tests/data/torch_e2e_oracle.npz``
(written by ``tests/test_torch_e2e_oracle.py`` with the JAX package on a
CPU).  The bars are the JAX tier's:

  * fp32 on the card, two-stage, against the fp32 oracle: mel MCD < 0.1 dB
    (graph faithfulness: the exact-FMA fp32 attention kernel, TF32 off)
  * bf16 on the card (the production point) against the fp32 oracle:
    < 0.3 dB; reported against the JAX package's own bf16 CPU run too
  * durations, bf16 on the card against the oracle: at most one frame
    apart, on at most 15 % of the tokens
  * fused against two-stage on the card: equal lengths, MCD < 0.15 dB
  * one bf16 training step (attention forward with lse, its backward, MAS
    on the card) against the oracle's step: the four losses within rtol
    0.05, grad_norm finite, update_l1 within rtol 0.10; the same bars for
    one fp32 step, which the JAX tier does not take

Each test prints a ``[card-e2e] <what>: MCD <x> dB`` (or ``<name> <x>``)
line, which ``python -m matcha_tpu_torch.utils.hw_gate`` collects.  Every
test carries the ``cuda`` marker and skips without a card.  This file
imports torch, numpy and the port only, so that it runs where there is no
JAX; ``tests/conftest.py`` imports JAX, so run it there without the
conftest:

    python -m pytest --noconftest tests/test_torch_cuda_e2e.py -q -s -m cuda
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.utils import hw_parity as hp
from matcha_tpu_torch.utils.mcd import mcd_dtw

pytestmark = pytest.mark.cuda

COUNTERS = hp.launch_counters()


def _report(what: str, **readings) -> None:
    text = ", ".join(f"MCD {v:.6g} dB" if k == "mcd" else f"{k} {v:.6g}" for k, v in readings.items())
    print(f"\n[card-e2e] {what}: {text}", flush=True)


def _launches() -> dict:
    return {n: c.launches for n, c in COUNTERS.items()}


@pytest.fixture(scope="module")
def oracle():
    if not torch.cuda.is_available():
        pytest.skip("the hardware parity tier runs on a card")
    data = hp.load_oracle()
    # same drawn weights on both sides — pin it, or every comparison below
    # is meaningless
    hp.check_fingerprints(data)
    return data


@pytest.fixture(scope="module")
def card_bf16(oracle):
    synth = hp.build_synthesizer("cuda", "bfloat16")
    for c in COUNTERS.values():
        c.reset()
    res = hp.synth_point("cuda", "bfloat16", ids=oracle["ids"], synth=synth)
    res["launches"] = _launches()
    return synth, res


def test_fp32_graph_faithful_on_card(oracle):
    """fp32 on the card against the fp32 CPU oracle: backend arithmetic
    only, through the fp32 attention kernel with TF32 off for cuBLAS and
    cuDNN (the synthesizer sets both)."""
    synth = hp.build_synthesizer("cuda", "float32")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    before = COUNTERS["masked_attention_fwd"].launches
    res = hp.synth_point("cuda", "float32", ids=oracle["ids"], synth=synth)
    assert COUNTERS["masked_attention_fwd"].launches > before, "fp32 synthesis never launched the kernel"
    ref = hp.oracle_synthesis(oracle, "fp32")
    assert len(res["wav"]) == len(ref["wav"]), "fp32 duration drift"
    cmp = hp.compare_synthesis(ref, res)
    _report("two-stage fp32 vs fp32 oracle", mcd=cmp["mel_mcd_db"],
            duration_max_diff=cmp["durations"]["max_abs_diff"])
    assert cmp["mel_mcd_db"] < hp.MEL_MCD_FP32_BAR_DB, cmp


def test_two_stage_bf16_mel_mcd(oracle, card_bf16):
    _, res = card_bf16
    assert res["launches"]["masked_attention_fwd"] > 0, res["launches"]
    ref = hp.oracle_synthesis(oracle, "fp32")
    # duration rounding may flip ±1 frame under bf16; the DTW distance
    # absorbs that, but a large length drift would mean broken pacing
    assert abs(len(res["wav"]) - len(ref["wav"])) <= 0.05 * max(len(ref["wav"]), 1) + 2 * 256
    mcd = hp.mel_mcd_db(ref["mel"], res["mel"])
    against_jax_bf16 = hp.mel_mcd_db(oracle["bf16_mel"], res["mel"])
    _report("two-stage bf16 vs fp32 oracle", mcd=mcd)
    _report("two-stage bf16 vs JAX bf16 CPU", mcd=against_jax_bf16)
    assert mcd < hp.MEL_MCD_BF16_BAR_DB, f"bf16-on-card mel MCD {mcd:.4f} dB"


def test_durations_match_oracle(oracle, card_bf16):
    _, res = card_bf16
    stats = hp.duration_stats(oracle["fp32_durations"], res["durations"])
    _report("durations bf16 vs fp32 oracle", max_abs_diff=stats["max_abs_diff"],
            fraction_differ=stats["fraction_differ"])
    # integer fine-frame durations: identical for all but rounding-edge
    # tokens, and never off by more than one frame
    assert stats["max_abs_diff"] <= hp.DURATION_MAX_DIFF, stats
    assert stats["fraction_differ"] <= hp.DURATION_DIFF_FRACTION, stats


def test_fused_matches_two_stage_on_card(oracle, card_bf16):
    synth, _ = card_bf16
    two = hp.synth_point("cuda", "bfloat16", ids=oracle["ids"], synth=synth)
    fused = hp.synth_point("cuda", "bfloat16", fused=True, ids=oracle["ids"], synth=synth)
    assert len(two["wav"]) == len(fused["wav"]), "duration drift between paths"
    mcd = mcd_dtw(two["wav"], fused["wav"], basis="mel", device="cuda")
    _report("fused vs two-stage on the card", mcd=mcd)
    assert mcd < hp.FUSED_MCD_BAR_DB, f"fused vs two-stage MCD {mcd:.4f} dB"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_against_oracle(oracle, dtype):
    batch, t_noise = hp.oracle_batch(oracle)
    for c in COUNTERS.values():
        c.reset()
    got = hp.train_step_point("cuda", dtype, batch, t_noise)
    launches = _launches()
    assert all(n > 0 for n in launches.values()), launches
    rel = hp.train_rel_diffs(hp.oracle_train(oracle), got)
    name = {"bfloat16": "bf16", "float32": "fp32"}[dtype]
    _report(f"train step {name} vs fp32 oracle", **{f"rel_{k.replace('/', '_')}": v for k, v in rel.items()})
    for key in hp.LOSS_KEYS:
        assert np.isfinite(got[key]), f"{key} non-finite on the card"
        assert rel[key] <= hp.TRAIN_LOSS_RTOL, (key, rel)
    assert np.isfinite(got["grad_norm"])
    # the applied update must be the same order of magnitude — a blown
    # bf16 gradient would show up here even if the loss agreed
    assert rel["update_l1"] <= hp.UPDATE_L1_RTOL, rel
