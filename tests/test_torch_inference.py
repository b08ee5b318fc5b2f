"""The port's synthesis path end to end vs the JAX MatchaSynthesizer.

tiny_config + a narrow Vocos, random JAX weights bridged into the port, the
same bucket ladders, and each package's own seeded noise row (the port's
reproduces the JAX draw, tests/test_torch_seeded_noise.py).  fp32 on the CPU.  Tolerances: mel 2e-3 absolute (denormalized
log-mel, std 6.5: eight U-Net evaluations of fp32 in another summation
order); waveform 1e-3 of its peak (the ISTFT amplifies mel differences
through exp()).  Within the port: fused == two-stage and batch ==
individual to 1e-4 (same arithmetic, different padding only).
"""

import jax
import numpy as np
import pytest
import torch

from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch.inference import MatchaSynthesizer, SynthesisResult, _to_host
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import init_params as torch_init_params
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params as torch_init_vocos
from matcha_tpu_torch.weights import params_from_jax, vocos_params_from_jax

WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
BUCKETS = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256))


@pytest.fixture(scope="module")
def pair():
    params = jax.tree.map(np.asarray, init_params(jax_tiny_config(), jax.random.PRNGKey(0)))
    vparams = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**WIDTHS)))
    ref = JaxSynthesizer(jax_tiny_config(), params, vparams, JaxVocosConfig(**WIDTHS), **BUCKETS)
    port = MatchaSynthesizer(
        tiny_config(), params_from_jax(params, tiny_config()),
        vocos_params_from_jax(vparams, VocosConfig(**WIDTHS)), VocosConfig(**WIDTHS),
        device="cpu", **BUCKETS,
    )
    return ref, port


def _ids(seed, n):
    return [int(i) for i in np.random.default_rng(seed).integers(0, 600, n)]


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 29)])
def test_mel_and_wav_match_jax(pair, seed, n):
    ref, port = pair
    ids = _ids(seed, n)
    r = ref.synthesise_ids(ids, speaker=1, n_timesteps=2, debug=True)
    p = port.synthesise_ids(ids, speaker=1, n_timesteps=2, debug=True)
    np.testing.assert_allclose(p.durations, r.durations, atol=1e-3)
    assert p.mel.shape == r.mel.shape
    np.testing.assert_allclose(p.mel, r.mel, atol=2e-3)
    assert p.wav.shape == r.wav.shape and len(p.wav) > 0
    np.testing.assert_allclose(p.wav, r.wav, atol=1e-3 * np.abs(r.wav).max())
    np.testing.assert_allclose(p.encoder_wav, np.asarray(r.encoder_wav), atol=1e-3 * np.abs(r.encoder_wav).max())


def test_fused_matches_jax(pair):
    ref, port = pair
    ids = _ids(2, 12)
    r = ref.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    p = port.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    assert p.wav.shape == r.wav.shape
    np.testing.assert_allclose(p.wav, r.wav, atol=1e-3 * np.abs(r.wav).max())


def test_fused_equals_two_stage(pair):
    _, port = pair
    ids = _ids(3, 14)
    two = port.synthesise_ids(ids, speaker=2, n_timesteps=2)
    fused = port.synthesise_ids(ids, speaker=2, n_timesteps=2, fused=True)
    assert isinstance(fused, SynthesisResult) and fused.wav.shape == two.wav.shape
    np.testing.assert_allclose(fused.wav, two.wav, atol=1e-4)


def test_fused_overflow_falls_back(pair, monkeypatch):
    _, port = pair
    ids = _ids(4, 14)
    two = port.synthesise_ids(ids, speaker=0, n_timesteps=2)
    monkeypatch.setattr(port, "fused_frames_per_token", 0.01)  # bucket far too small
    fused = port.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    np.testing.assert_allclose(fused.wav, two.wav, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_batch_equals_individual(pair, fused):
    _, port = pair
    lists = [_ids(5, 9), _ids(6, 20), _ids(7, 4)]
    batch = port.synthesise_batch(lists, speakers=[0, 3, 1], n_timesteps=2, fused=fused)
    for ids, spk, got in zip(lists, [0, 3, 1], batch):
        single = port.synthesise_ids(ids, speaker=spk, n_timesteps=2)
        assert got.wav.shape == single.wav.shape
        np.testing.assert_allclose(got.wav, single.wav, atol=1e-4)


def test_batch_matches_jax_batch(pair):
    ref, port = pair
    lists = [_ids(8, 11), _ids(9, 25)]
    r = ref.synthesise_batch(lists, speakers=[0, 1], n_timesteps=2)
    p = port.synthesise_batch(lists, speakers=[0, 1], n_timesteps=2)
    for a, b in zip(p, r):
        np.testing.assert_allclose(a.wav, b.wav, atol=1e-3 * np.abs(b.wav).max())


def test_buckets_and_helpers_match_jax(pair):
    ref, port = pair
    assert port.text_buckets == ref.text_buckets
    assert port.mel_fine_buckets == ref.mel_fine_buckets
    assert port.reachable_bucket_pairs() == ref.reachable_bucket_pairs()
    for tx in port.text_buckets:
        for scale in (0.1, 1.0, 2.16):
            assert port.predict_fine_bucket(tx, scale) == ref.predict_fine_bucket(tx, scale)
        assert port.fused_warm_buckets(tx) == ref.fused_warm_buckets(tx)
    e, d = port.speaker_embedding([(0, 0.7), (2, 0.3)])
    re, rd = ref.speaker_embedding([(0, 0.7), (2, 0.3)])
    np.testing.assert_allclose(e.numpy(), np.asarray(re), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), atol=1e-6)


def test_warmup_walks_the_batch_ladder(pair):
    _, port = pair
    seen = []
    port.warmup(n_timesteps=1, batch_sizes=(1, 2), on_size_ready=seen.append)
    assert seen == [1, 2]


def test_to_host_is_one_copy_of_several():
    a, b = torch.arange(6).reshape(2, 3).int(), torch.ones((2, 2))
    got = _to_host(a, b)
    np.testing.assert_array_equal(got[0], a.numpy())
    np.testing.assert_array_equal(got[1], b.numpy())


def test_seeded_noise_is_deterministic_and_batch_invariant():
    cfg = tiny_config()
    gen = torch.Generator().manual_seed(0)
    params = torch_init_params(cfg, gen)
    vparams = torch_init_vocos(VocosConfig(**WIDTHS), gen)
    synth = MatchaSynthesizer(cfg, params, vparams, VocosConfig(**WIDTHS), device="cpu", **BUCKETS)
    ids = _ids(10, 13)
    a = synth.synthesise_ids(ids, speaker=0, n_timesteps=2)
    b = synth.synthesise_ids(ids, speaker=0, n_timesteps=2)
    np.testing.assert_array_equal(a.wav, b.wav)
    assert np.isfinite(a.wav).all() and np.abs(a.wav).max() > 0
    batch = synth.synthesise_batch([_ids(11, 5), ids], speakers=[1, 0], n_timesteps=2)
    np.testing.assert_allclose(batch[1].wav, a.wav, atol=1e-4)
