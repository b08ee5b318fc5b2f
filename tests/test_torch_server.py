"""The port's HTTP server over real sockets, torch synthesizer on the CPU.

Mirrors tests/test_server_http.py for ``matcha_tpu_torch.serving.server``:
/health, pretokenized requests (``phoneme_ids``) answered as WAV, concurrent
requests grouped by the batcher.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from matcha_tpu_torch.inference import MatchaSynthesizer
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import init_params
from matcha_tpu_torch.serving.server import TTSService, make_handler, parse_voice
from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params

CFG = tiny_config()
VCFG = VocosConfig(input_channels=CFG.n_feats, dim=32, intermediate_dim=64, num_layers=1)


@pytest.fixture(scope="module")
def server():
    gen = torch.Generator().manual_seed(0)
    synth = MatchaSynthesizer(
        CFG, init_params(CFG, gen), init_vocos_params(VCFG, gen), VCFG,
        text_buckets=(16, 32), mel_fine_buckets=(64, 128, 256), device="cpu",
    )
    service = TTSService(synth, use_batcher=True)
    service.warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    service.batcher.shutdown()
    thread.join(timeout=5)


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/audio/speech", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _wav_samples(data: bytes) -> int:
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    with wave.open(io.BytesIO(data)) as f:
        assert f.getframerate() == 24000 and f.getnchannels() == 1
        return f.getnframes()


def test_health(server):
    url, _ = server
    with urllib.request.urlopen(url + "/health", timeout=10) as resp:
        assert resp.status == 200
        assert json.loads(resp.read())["status"] == "ok"


def test_phoneme_ids_to_wav(server):
    url, _ = server
    ids = [int(i) for i in np.random.default_rng(0).integers(1, 600, 12)]
    status, ctype, data = _post(url, {"phoneme_ids": ids, "response_format": "wav", "steps": 2})
    assert status == 200 and ctype == "audio/wav"
    n = _wav_samples(data)
    assert 0 < n and (n - 1) // 256 < 256  # at most the largest mel bucket


def test_concurrent_requests_are_grouped(server, monkeypatch):
    url, service = server
    sizes = []
    real = service.synth.synthesise_batch

    def spy(id_lists, **kw):
        sizes.append(len(id_lists))
        return real(id_lists, **kw)

    monkeypatch.setattr(service.synth, "synthesise_batch", spy)
    monkeypatch.setattr(service.batcher, "max_wait", 0.5)
    lists = [[int(i) for i in np.random.default_rng(s).integers(1, 600, 9)] for s in (1, 2)]
    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(
            lambda ids: _post(url, {"phoneme_ids": ids, "response_format": "wav", "voice": "1"}), lists
        ))
    for status, _, data in results:
        assert status == 200 and _wav_samples(data) > 0
    assert max(sizes) == 2


def test_bad_request_is_400(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(url, {"phoneme_ids": [9999]})
    assert exc.value.code == 400


def test_parse_voice():
    assert parse_voice("2") == [(2, 1.0)]
    assert parse_voice("2(70)+6(30)") == [(2, 0.7), (6, 0.3)]


class _PointRecorder:
    """A synthesizer stand-in that records the operating point of each group."""

    def __init__(self):
        self.points = []

    def synthesise_batch(self, id_lists, n_timesteps, solver, **_):
        from matcha_tpu_torch.inference import SynthesisResult

        self.points.append((n_timesteps, solver))
        return [SynthesisResult(wav=np.zeros(4, np.float32), rtf=0.0) for _ in id_lists]


def test_submit_without_a_point_gets_the_batchers():
    from matcha_tpu_torch.serving.batcher import RequestBatcher

    synth = _PointRecorder()
    batcher = RequestBatcher(synth, max_wait_ms=1.0, n_timesteps=2, solver="euler")
    try:
        batcher.submit([1, 2, 3]).result(timeout=30)
        batcher.submit([1, 2, 3], n_timesteps=6, solver="rk4").result(timeout=30)
    finally:
        batcher.shutdown()
    assert synth.points == [(2, "euler"), (6, "rk4")]


def test_service_batcher_serves_the_servers_point(monkeypatch):
    """A direct ``submit`` with no point is served at DEFAULT_STEPS /
    DEFAULT_SOLVER, the point the server warms up."""
    monkeypatch.setenv("DEFAULT_STEPS", "3")
    monkeypatch.setenv("DEFAULT_SOLVER", "euler")
    synth = _PointRecorder()
    service = TTSService(synth, use_batcher=True)
    try:
        service.batcher.submit([5, 6]).result(timeout=30)
    finally:
        service.batcher.shutdown()
    assert synth.points == [(3, "euler")]
