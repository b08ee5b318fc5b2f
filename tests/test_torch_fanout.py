"""The synthesizer's fan-out over a device list, on four CPU "devices".

Mirrors ``tests/test_multichip_inference.py`` (the JAX synthesizer on an
8-device CPU mesh): ``MatchaSynthesizer(mesh=["cpu"] * 4)`` holds four
replicas, pads every batch to a device multiple, runs each replica's block
of rows from its own thread, and must return the single synthesizer's rows.
Tolerance: 1e-4 absolute on the waveform, as the JAX test (the same
arithmetic on other batch shapes: blocks of rows instead of the whole
batch).  No JAX needed.
"""

import threading

import numpy as np
import pytest
import torch

from matcha_tpu_torch.inference import MatchaSynthesizer
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import init_params
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params

CFG = tiny_config()
VCFG = VocosConfig(input_channels=CFG.n_feats, dim=32, intermediate_dim=64, num_layers=1)
N_DEV = 4


@pytest.fixture(scope="module")
def synths():
    gen = torch.Generator().manual_seed(0)
    params = init_params(CFG, gen)
    vocos_params = init_vocos_params(VCFG, gen)
    kw = dict(text_buckets=(16, 32), mel_fine_buckets=(64, 128, 256))
    single = MatchaSynthesizer(CFG, params, vocos_params, VCFG, device="cpu", **kw)
    fanout = MatchaSynthesizer(CFG, params, vocos_params, VCFG, mesh=["cpu"] * N_DEV, **kw)
    return single, fanout


def id_lists(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(i) for i in rng.integers(0, 600, n)] for n in lengths]


def assert_rows_match(r_single, r_fanout):
    assert len(r_single) == len(r_fanout)
    for a, b in zip(r_single, r_fanout):
        assert a.wav.shape == b.wav.shape and len(a.wav) > 0
        np.testing.assert_allclose(a.wav, b.wav, atol=1e-4)


def test_replicas_hold_their_own_weights(synths):
    _, fanout = synths
    assert fanout.n_dev == len(fanout.replicas) == N_DEV
    models = {id(r.model) for r in fanout.replicas}
    assert len(models) == N_DEV
    a, b = fanout.replicas[0].model.state_dict(), fanout.replicas[3].model.state_dict()
    assert all(torch.equal(a[k], b[k]) and a[k].data_ptr() != b[k].data_ptr() for k in a)


@pytest.mark.parametrize("fused", [False, True])
def test_batch_matches_single_device(synths, fused):
    single, fanout = synths
    lists = id_lists(0, (6, 9, 12, 7))
    speakers = [0, 1, 2, 3]
    assert_rows_match(single.synthesise_batch(lists, speakers, n_timesteps=2, fused=fused),
                      fanout.synthesise_batch(lists, speakers, n_timesteps=2, fused=fused))


def test_non_multiple_batch_padding(synths):
    """3 requests over 4 devices pad to 4 rows (and 5 to 8)."""
    single, fanout = synths
    for lengths in ((8, 8, 8), (5, 9, 7, 11, 6)):
        lists = id_lists(len(lengths), lengths)
        speakers = list(range(len(lengths)))
        speakers = [s % CFG.n_spks for s in speakers]
        assert_rows_match(single.synthesise_batch(lists, speakers, n_timesteps=2, fused=True),
                          fanout.synthesise_batch(lists, speakers, n_timesteps=2, fused=True))
    assert [fanout._pad_batch(b) for b in (1, 3, 5, 8, 9)] == [4, 4, 8, 8, 16]


@pytest.mark.parametrize("fused", [False, True])
def test_single_request_matches_single_device(synths, fused):
    """A request pads to one row per device, the pad rows one token long."""
    single, fanout = synths
    (ids,) = id_lists(2, (10,))
    a = single.synthesise_ids(ids, speaker=1, n_timesteps=2, fused=fused)
    b = fanout.synthesise_ids(ids, speaker=1, n_timesteps=2, fused=fused)
    assert_rows_match([a], [b])


def test_debug_request_matches_single_device(synths):
    single, fanout = synths
    (ids,) = id_lists(5, (9,))
    a = single.synthesise_ids(ids, speaker=2, n_timesteps=2, debug=True)
    b = fanout.synthesise_ids(ids, speaker=2, n_timesteps=2, debug=True)
    np.testing.assert_allclose(b.mel, a.mel, atol=1e-4)
    np.testing.assert_array_equal(b.durations, a.durations)
    np.testing.assert_allclose(b.encoder_wav, a.encoder_wav, atol=1e-4)


def test_overflow_falls_back_on_gathered_totals(synths, monkeypatch):
    single, fanout = synths
    lists = id_lists(6, (12, 14))
    want = single.synthesise_batch(lists, [0, 1], n_timesteps=2)
    monkeypatch.setattr(fanout, "fused_frames_per_token", 0.01)  # bucket far too small
    assert_rows_match(want, fanout.synthesise_batch(lists, [0, 1], n_timesteps=2, fused=True))


def test_each_replica_runs_on_its_own_thread(synths, monkeypatch):
    _, fanout = synths
    seen = []
    for rep in fanout.replicas:
        real = rep.encode

        def spy(*args, _real=real, _rep=rep):
            seen.append((id(_rep), threading.get_ident()))
            return _real(*args)

        monkeypatch.setattr(rep, "encode", spy)
    fanout.synthesise_batch(id_lists(7, (5, 6, 7, 8)), [0, 1, 2, 3], n_timesteps=1)
    assert len({r for r, _ in seen}) == N_DEV and len({t for _, t in seen}) == N_DEV
    assert threading.get_ident() not in {t for _, t in seen}


def test_warmup_then_fused_request(synths):
    _, fanout = synths
    fanout.warmup(n_timesteps=2, batch_sizes=(1,), fused=True)
    (ids,) = id_lists(4, (10,))
    r = fanout.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    assert np.isfinite(r.wav).all() and len(r.wav) > 0


def test_progressive_hook_sees_device_multiple_rungs(synths):
    """Warmup pads the group ladder to device multiples, so the hook only
    reports padded rungs."""
    _, fanout = synths
    seen = []
    fanout.warmup(n_timesteps=1, batch_sizes=(1, 2, 16), on_size_ready=seen.append)
    assert seen == [4, 16]


def test_empty_mesh_raises():
    with pytest.raises(ValueError):
        MatchaSynthesizer(CFG, init_params(CFG, torch.Generator().manual_seed(0)), mesh=[])
