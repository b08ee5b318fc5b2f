"""A request's audio does not depend on the mel bucket it is decoded in.

The JAX package promises it for its masked GroupNorm, whose statistics
cover valid frames only, "making bucketed inference invariant to bucket
choice and batch composition" (``matcha_tpu/models/decoder.py``), and for
its seeded noise, invariant to batch size, row position and bucket
(``matcha_tpu/inference.py``); its ``tests/test_inference_e2e.py`` holds
the fused program forced onto the largest bucket against two-stage.

The port holds the same promise bit for bit, in bf16, on the CPU:

- ``GroupNorm`` (fp32 and bf16-path statistics, one and three rows of
  different valid lengths): the same valid frames padded to T and to 2T,
  with junk in the padding, give bit-equal statistics and valid frames;
- at ``tiny_config()``: the fused path forced onto the largest mel bucket
  against two-stage, each row bit-equal (the JAX test's port);
- one request alone and beside a slower neighbour that moves the group to
  a larger mel bucket, the text bucket unchanged: bit-equal on its samples.

At tiny widths torch's CPU sums over the whole bucket, which the masked
GroupNorm took before, happened to agree in every bucket; the GroupNorm
test, at the decoder's width and layout, and ``test_torch_fused_parting.py``
at full width are the ones that failed on them.  With the decoder at its
production channels (320) and more rows or frames, the first module to
part on the CPU is an FFN's output projection (``ff.net.2``, a bf16
``F.linear`` whose blocking the CPU library picks by the rows times frames
it is given): a library's choice by shape, not the statistics.
"""

import dataclasses

import numpy as np
import pytest
import torch

from matcha_tpu_torch.bench import pin_durations
from matcha_tpu_torch.inference import MatchaSynthesizer, pick_bucket
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.layers import GroupNorm
from matcha_tpu_torch.models.matcha import init_params
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params

WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
BUCKETS = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256))


def padded(x: torch.Tensor, lengths, t: int, gen: torch.Generator):
    """``x`` (B, T0, C) padded to ``t`` frames with non-zero junk past each
    row's valid length, and the (B, t) mask of those lengths."""
    b, t0, c = x.shape
    out = torch.randn((b, t, c), generator=gen) * 50 + 3
    mask = torch.zeros((b, t))
    for i, n in enumerate(lengths):
        out[i, :n] = x[i, :n]
        mask[i, :n] = 1
    return out.to(x.dtype), mask


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("f32_stats", [True, False])
def test_group_norm_statistics_ignore_padding(f32_stats, b):
    """At the decoder's width (320 channels, 8 groups) and in its layout (a
    conv's output, time innermost), fp32 out as under the fp32 carry."""
    gen = torch.Generator().manual_seed(b)
    c, t = 320, 128
    lengths = [101, 128, 7][:b]
    x = (torch.randn((b, t, c), generator=gen) * 4 + 1).to(torch.bfloat16)
    gn = GroupNorm(8, c, eps=1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.randn(c, generator=gen))
        gn.bias.copy_(torch.randn(c, generator=gen))
    runs = []
    for tt in (t, 2 * t):
        xp, mask = padded(x, lengths, tt, gen)
        xp = xp.transpose(1, 2).contiguous().transpose(1, 2)
        xg = xp.reshape(b, tt, 8, c // 8)
        stats = gn.statistics(xg.float() if f32_stats else xg, mask, torch.float32, f32_stats)
        runs.append((stats, gn(xp, mask, out_dtype=torch.float32, f32_stats=f32_stats)))
    (stats_a, y_a), (stats_b, y_b) = runs
    for sa, sb in zip(stats_a, stats_b):
        assert sa.shape == (b, 1, 8, 1) and torch.isfinite(sa).all()
        assert torch.equal(sa, sb)
    for i, n in enumerate(lengths):
        assert torch.equal(y_a[i, :n], y_b[i, :n])
    # and they are the statistics of the valid frames alone
    for i, n in enumerate(lengths):
        v = x[i, :n].double().reshape(n, 8, c // 8)
        want = (v.mean(dim=(0, 2)), v.var(dim=(0, 2), unbiased=False))
        for got, ref in zip(stats_a, want):
            torch.testing.assert_close(got[i, 0, :, 0].double(), ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def synth():
    """tiny_config in bf16, random weights, the duration head pinned at 4
    fine frames a token (random log-durations collapse to one frame)."""
    cfg = dataclasses.replace(tiny_config(), compute_dtype="bfloat16")
    vcfg = VocosConfig(**WIDTHS, compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    return MatchaSynthesizer(cfg, pin_durations(init_params(cfg, gen)), init_vocos_params(vcfg, gen), vcfg,
                             device="cpu", **BUCKETS)


def _ids(seed, n):
    return [int(i) for i in np.random.default_rng(seed).integers(0, 600, n)]


def decode_buckets(synth, monkeypatch) -> list[int]:
    """Records the fine mel bucket of every decode the synthesizer runs."""
    seen, real = [], synth._run_decode
    monkeypatch.setattr(synth, "_run_decode",
                        lambda *a, y_fine_len, **kw: seen.append(y_fine_len) or real(*a, y_fine_len=y_fine_len, **kw))
    return seen


def test_fused_batch_matches_across_bucket_mismatch(synth, monkeypatch):
    """The fused program forced onto the largest bucket against two-stage
    at the one its durations pick: each row bit-equal."""
    id_lists = [_ids(7 + k, n) for k, n in enumerate((8, 12, 5))]
    seen = decode_buckets(synth, monkeypatch)
    two = synth.synthesise_batch(id_lists, speakers=[0, 1, 2], n_timesteps=2)
    assert seen == [64]
    monkeypatch.setattr(synth, "predict_fine_bucket", lambda tx, scale=1.0: 256)
    one = synth.synthesise_batch(id_lists, speakers=[0, 1, 2], n_timesteps=2, fused=True)
    assert seen == [64]  # the fused program did not fall back
    for a, b in zip(one, two):
        assert len(a.wav) == len(b.wav) > 0
        assert np.isfinite(a.wav).all()
        np.testing.assert_array_equal(a.wav, b.wav)


def test_request_alone_and_beside_a_slower_neighbour(synth, monkeypatch):
    """Row 0 decoded alone and in a group whose slower neighbour (same text
    bucket) moves the group to a larger mel bucket: bit-equal."""
    ids, neighbour = _ids(20, 10), _ids(21, 14)
    assert pick_bucket(len(ids), synth.text_buckets) == pick_bucket(len(neighbour), synth.text_buckets)
    seen = decode_buckets(synth, monkeypatch)
    alone = synth.synthesise_batch([ids], speakers=[1], n_timesteps=2)[0]
    grouped = synth.synthesise_batch([ids, neighbour], speakers=[1, 3], n_timesteps=2,
                                     length_scales=[1.0, 2.0])
    assert seen == [64, 128]
    assert len(grouped[1].wav) > len(alone.wav) > 0
    np.testing.assert_array_equal(grouped[0].wav, alone.wav)
