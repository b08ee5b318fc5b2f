"""The one generator of traffic: request pools, arrival times and corpora
from a mix's parameters and the run's seed.

Every seed gets the same set of sizes and gaps, drawn once from the mix's
``base_seed``, in its own order; the phoneme ids themselves come from the
seed.  So runs on different seeds do the same work in another order, and
a run is reproduced exactly by its seed.

Mix parameters (see ``traffic/*.json``):
  ids:    {"median", "sigma", "min", "max"}  lognormal lengths, clipped
  voices: {"count", "blend_share"}           uniform speakers; that share
                                             of requests a 50/50 blend of two
  rate_per_s                                 open loop: Poisson arrivals
  pool                                       closed loop: requests in the pool
  corpus: {"utterances", "median_frames", "sigma", "min_frames",
           "max_frames", "ids_per_frame", "speakers"}
"""

from __future__ import annotations

import numpy as np

VOCAB = 600  # phoneme ids 0..599; 0 is padding, so requests use 1..599


def lognormal_lengths(rng, spec: dict, n: int) -> np.ndarray:
    raw = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.round(raw), spec["min"], spec["max"]).astype(int)


def voice_spec(rng, spec: dict, n: int) -> list[str]:
    first = rng.integers(0, spec["count"], n)
    second = (first + rng.integers(1, spec["count"], n)) % spec["count"]
    blend = rng.random(n) < spec["blend_share"]
    return [f"{a}(50)+{b}(50)" if m else str(a) for a, b, m in zip(first, second, blend)]


def request_pool(mix: dict, seed: int, n: int) -> list[dict]:
    """``n`` request bodies: the mix's lengths and voices in the seed's order,
    ids drawn from the seed."""
    base = np.random.default_rng(mix["base_seed"])
    lengths = lognormal_lengths(base, mix["ids"], n)
    voices = voice_spec(base, mix["voices"], n)
    order = np.random.default_rng([seed, 0]).permutation(n)
    ids_rng = np.random.default_rng([seed, 1])
    return [{"phoneme_ids": ids_rng.integers(1, VOCAB, lengths[k]).tolist(), "voice": voices[k],
             "response_format": "wav"} for k in order]


def arrivals(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream at
    ``rate_per_s``: round(rate · seconds) arrivals, which for a Poisson
    process are uniform order statistics; the gaps drawn once from the
    base seed, shuffled by the seed."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    base = np.random.default_rng(mix["base_seed"] + 1)
    times = np.sort(base.uniform(0.0, seconds, n))
    gaps = np.diff(np.concatenate([[0.0], times]))
    return np.cumsum(np.random.default_rng([seed, 2]).permutation(gaps))


def voice_mix(voice: str) -> list[tuple[int, float]]:
    """'3' → [(3, 1.0)]; '3(50)+7(50)' → [(3, .5), (7, .5)]."""
    parts = []
    for term in voice.split("+"):
        spk, _, rest = term.partition("(")
        parts.append((int(spk), float(rest.rstrip(")")) if rest else 100.0))
    total = sum(w for _, w in parts)
    return [(s, w / total) for s, w in parts]


def corpus(spec: dict, base_seed: int) -> list[dict]:
    """Utterances of a synthetic read-speech corpus: coarse frame counts
    lognormal, ids ≈ frames · ids_per_frame, speakers uniform; each with
    the seed of its mel and ids."""
    rng = np.random.default_rng(base_seed)
    frames = lognormal_lengths(rng, {"median": spec["median_frames"], "sigma": spec["sigma"],
                                     "min": spec["min_frames"], "max": spec["max_frames"]}, spec["utterances"])
    spk = rng.integers(0, spec["speakers"], spec["utterances"])
    return [{"frames": int(f), "n_ids": max(1, int(round(f * spec["ids_per_frame"]))), "speaker": int(s),
             "seed": [base_seed, k]} for k, (f, s) in enumerate(zip(frames, spk))]
