"""The one traffic generator: deterministic for each seed, the same sizes
for every seed, the mixes' parameters honoured."""

import numpy as np

from benchmark import harness, workload_gen


def _mix(name):
    return harness.mix(name)


def test_pool_is_deterministic_for_a_seed():
    mix = _mix("interactive-poisson")
    a = workload_gen.request_pool(mix, 2**31 + 11, 50)
    b = workload_gen.request_pool(mix, 2**31 + 11, 50)
    assert a == b


def test_every_seed_gets_the_same_sizes_and_voices_in_another_order():
    mix = _mix("interactive-poisson")
    a = workload_gen.request_pool(mix, 3, 200)
    b = workload_gen.request_pool(mix, 4, 200)
    assert sorted(len(r["phoneme_ids"]) for r in a) == sorted(len(r["phoneme_ids"]) for r in b)
    assert sorted(r["voice"] for r in a) == sorted(r["voice"] for r in b)
    assert [len(r["phoneme_ids"]) for r in a] != [len(r["phoneme_ids"]) for r in b]
    assert a[0]["phoneme_ids"] != b[0]["phoneme_ids"]


def test_lengths_voices_and_blends_follow_the_mix():
    mix = _mix("interactive-poisson")
    pool = workload_gen.request_pool(mix, 5, 3000)
    n = np.array([len(r["phoneme_ids"]) for r in pool])
    assert n.min() >= mix["ids"]["min"] and n.max() <= mix["ids"]["max"]
    assert abs(np.median(n) - mix["ids"]["median"]) <= 3
    blends = [r["voice"] for r in pool if "+" in r["voice"]]
    assert abs(len(blends) / len(pool) - mix["voices"]["blend_share"]) < 0.03
    for v in blends[:50]:
        (a, wa), (b, wb) = workload_gen.voice_mix(v)
        assert a != b and wa == wb == 0.5
    ids = np.concatenate([r["phoneme_ids"] for r in pool])
    assert ids.min() >= 1 and ids.max() < workload_gen.VOCAB


def test_arrivals_are_the_same_gaps_in_another_order():
    mix = _mix("interactive-poisson")
    a = workload_gen.arrivals(mix, 1, 51)
    b = workload_gen.arrivals(mix, 2, 51)
    assert len(a) == len(b) == round(mix["rate_per_s"] * 51)
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert np.all(np.diff(a) >= 0) and a[-1] <= 51 + 1e-9
    assert np.array_equal(a, workload_gen.arrivals(mix, 1, 51))


def test_corpus_is_fixed_by_its_parameters():
    spec = _mix("readspeech-corpus")["corpus"]
    a = workload_gen.corpus(spec, 3041)
    assert a == workload_gen.corpus(spec, 3041)
    frames = np.array([u["frames"] for u in a])
    assert len(a) == spec["utterances"]
    assert frames.min() >= spec["min_frames"] and frames.max() <= spec["max_frames"]
    assert abs(np.median(frames) - spec["median_frames"]) < 25
    assert {u["speaker"] for u in a} == set(range(spec["speakers"]))
