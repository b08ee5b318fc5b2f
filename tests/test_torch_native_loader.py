"""The port's native loader against ``matcha_tpu.data.native_loader`` and
the numpy path.

The port builds the library from ``native/src`` with ``g++`` into
``matcha_tpu_torch/ops/build/``; the JAX package loads the tracked
``native/libmatcha_native.so``.  Both run the same C code, so every
comparison here is exact (``np.array_equal``): ``fill_batch`` and
``mel_length`` on channel-major, time-major, Fortran-order and truncated
caches; ``fill_batch(out=)`` into a tensor; ``collate(use_native=True)``
against ``collate_numpy`` and the JAX ``collate``, a data-parallel block
included; ``dataset.mel_length`` from the header; a failed build tried
once; the server's warmup building the library; the Ogg/Opus bytes of the
port's encoder against the JAX package's.  Tests that build skip, with the reason, only where ``g++`` is missing.
"""

from __future__ import annotations

import ctypes.util
import shutil
import threading
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from matcha_tpu.data import native_loader as jax_loader
from matcha_tpu_torch.data import native_loader

N_MELS = 8


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the native loader cannot be built")
    return native_loader.load_library()


def _caches(root, kind: str):
    """Three caches of 10, 37 and 64 frames as ``kind`` lays them out, and
    their time-major (T, n_mels) contents."""
    rng = np.random.default_rng({"channel": 0, "time": 1, "fortran": 2}[kind])
    paths, arrays = [], []
    for i, frames in enumerate([10, 37, 64]):
        a = rng.standard_normal((N_MELS, frames)).astype(np.float32)
        stored = {"channel": a, "time": np.ascontiguousarray(a.T), "fortran": np.asfortranarray(a)}[kind]
        p = root / f"{kind}{i}.npy"
        np.save(p, stored)
        paths.append(p)
        arrays.append(a.T)
    return paths, arrays


@pytest.mark.parametrize("kind", ["channel", "time", "fortran"])
@pytest.mark.parametrize("t_pad", [70, 20], ids=["padded", "truncated"])
def test_fill_batch_equals_jax_and_numpy(lib, tmp_path, kind, t_pad):
    paths, arrays = _caches(tmp_path, kind)
    batch, lens = native_loader.fill_batch(paths, t_pad, N_MELS)
    want, want_lens = jax_loader.fill_batch(paths, t_pad, N_MELS)
    assert batch.dtype == np.float32 and batch.shape == (3, t_pad, N_MELS)
    assert np.array_equal(batch, want) and np.array_equal(lens, want_lens)
    for k, a in enumerate(arrays):
        t = min(len(a), t_pad)
        assert lens[k] == t
        assert np.array_equal(batch[k, :t], a[:t]) and not batch[k, t:].any()


@pytest.mark.parametrize("kind", ["channel", "time", "fortran"])
def test_mel_length_equals_jax(lib, tmp_path, kind):
    paths, arrays = _caches(tmp_path, kind)
    for p, a in zip(paths, arrays):
        assert native_loader.mel_length(p) == jax_loader.mel_length(p)
        if kind != "time":  # the C function reads the second dimension
            assert native_loader.mel_length(p) == len(a)
    with pytest.raises(IOError):
        native_loader.mel_length(tmp_path / "missing.npy")


def test_fill_batch_into_a_tensor(lib, tmp_path):
    paths, _ = _caches(tmp_path, "channel")
    out = torch.full((3, 40, N_MELS), 7.0)
    got, lens = native_loader.fill_batch(paths, 40, N_MELS, out=out)
    assert got is out
    want, want_lens = native_loader.fill_batch(paths, 40, N_MELS)
    assert np.array_equal(out.numpy(), want) and np.array_equal(lens, want_lens)
    for bad in (torch.empty((3, 40, N_MELS), dtype=torch.float64), torch.empty((3, N_MELS, 40)).transpose(1, 2),
                torch.empty((2, 40, N_MELS))):
        with pytest.raises(ValueError):
            native_loader.fill_batch(paths, 40, N_MELS, out=bad)


@pytest.fixture()
def corpus(tmp_path):
    """Six utterances with coarse and fine channel-major caches."""
    rng = np.random.default_rng(1)
    mel_dir = tmp_path / "mels"
    (mel_dir / "s").mkdir(parents=True)
    rows = []
    for i in range(6):
        frames = int(rng.integers(16, 60))
        np.save(mel_dir / f"s/u{i}.npy", rng.standard_normal((N_MELS, frames)).astype(np.float32))
        np.save(mel_dir / f"s/u{i}.fine.npy", rng.standard_normal((N_MELS, 2 * frames)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(0, 600, 12))
        rows.append(f"s/u{i}|{i % 2}|en-us|text|{ids}")
    (mel_dir / "metadata.json").write_text('{"n_mels": %d}' % N_MELS)
    filelist = tmp_path / "fl.csv"
    filelist.write_text("\n".join(rows))
    return filelist, mel_dir


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)], ids=["whole", "block0", "block1"])
def test_collate_native_equals_numpy_and_jax(lib, corpus, shard):
    from matcha_tpu.data.collate import collate as jax_collate
    from matcha_tpu.data.dataset import TextMelDataset as JaxDataset
    from matcha_tpu_torch.data.collate import collate, collate_numpy
    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.data.sampler import BucketPlan
    from matcha_tpu_torch.parallel.mesh import row_block

    ds = TextMelDataset(*corpus)
    plan = BucketPlan(mel_len=48, batch_size=6, indices=[0, 1, 2, 3, 4, 1], n_real=5)
    before = native_loader.fill_batch_count.launches
    got = collate(ds, plan, shard=shard, use_native=True)
    assert native_loader.fill_batch_count.launches == before + 2  # coarse and fine
    numpy_batch = collate_numpy(ds, plan, shard=shard)
    rows = row_block(6, *shard) if shard else slice(None)
    jax_batch = jax_collate(JaxDataset(*corpus), plan, use_native=True)
    for g, n, j in zip(got, numpy_batch, jax_batch):
        assert g.dtype == torch.from_numpy(n).dtype
        assert np.array_equal(g.numpy(), n) and np.array_equal(g.numpy(), np.asarray(j)[rows])
    assert not got.y.is_pinned()  # pinned only where CUDA is available


def test_dataset_mel_length_from_header(tmp_path):
    from matcha_tpu_torch.data.dataset import TextMelDataset

    rng = np.random.default_rng(5)
    (tmp_path / "m").mkdir()
    rows = []
    # channel-major, time-major, Fortran-order, and a cache with T == n_mels
    for i, (frames, layout) in enumerate([(21, "c"), (33, "t"), (17, "f"), (N_MELS, "c"), (N_MELS, "t")]):
        a = rng.standard_normal((N_MELS, frames)).astype(np.float32)
        stored = {"c": a, "t": np.ascontiguousarray(a.T), "f": np.asfortranarray(a)}[layout]
        np.save(tmp_path / f"m/u{i}.npy", stored)
        rows.append(f"u{i}|0|en-us|text|1 2 3")
    (tmp_path / "fl.csv").write_text("\n".join(rows))
    ds = TextMelDataset(tmp_path / "fl.csv", tmp_path / "m", N_MELS)
    assert [ds.mel_length(i) for i in range(len(ds))] == [21, 33, 17, N_MELS, N_MELS]


def test_a_failed_build_is_remembered(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native_loader.NATIVE_SRC, src)
    (src / "dataloader.cpp").write_text("#error broken on purpose\n")
    monkeypatch.setattr(native_loader, "NATIVE_SRC", src)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_library", None)
    monkeypatch.setattr(native_loader, "_error", None)
    runs = []
    real_run = native_loader.subprocess.run
    monkeypatch.setattr(native_loader.subprocess, "run", lambda *a, **k: runs.append(a) or real_run(*a, **k))
    assert not native_loader.available() and not native_loader.available()
    with pytest.raises(RuntimeError, match="native loader"):
        native_loader.load_library()
    from matcha_tpu_torch.utils import opus_converter  # asks on every Ogg request

    assert not opus_converter.available()
    assert len(runs) == 1  # one compiler run, whatever asked again


def test_server_warmup_builds_the_library(monkeypatch):
    from matcha_tpu_torch.serving.server import TTSService

    monkeypatch.setattr(native_loader, "_library", None)
    monkeypatch.setattr(native_loader, "_error", None)
    calls = []
    monkeypatch.setattr(native_loader, "build_library", lambda: calls.append(1) or native_loader.library_path())
    fake = NS(mtpu_opus_ogg_encode=NS(), mtpu_opus_ogg_free=NS())  # the encoder's symbols
    monkeypatch.setattr(native_loader, "ctypes", NS(CDLL=lambda path: fake))
    monkeypatch.setattr(native_loader, "_bind", lambda lib: lib)

    class Synth:  # the warmup's synthesizer calls are not what is checked
        def warmup(self, **kwargs):
            pass

    service = TTSService(Synth(), use_batcher=False)
    assert not native_loader.loaded()
    service.warmup()
    assert calls == [1] and native_loader.loaded() and service.ready


def test_build_key_follows_sources_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native_loader.NATIVE_SRC, src)
    monkeypatch.setattr(native_loader, "NATIVE_SRC", src)
    first = native_loader.library_path()
    assert first.parent == native_loader.BUILD_DIR and first.name.startswith("libmatcha_native_")
    (src / "dataloader.cpp").write_text((src / "dataloader.cpp").read_text() + "\n// edited\n")
    second = native_loader.library_path()
    monkeypatch.setattr(native_loader, "CXX_FLAGS", native_loader.CXX_FLAGS + ("-g",))
    third = native_loader.library_path()
    assert len({first, second, third}) == 3


def test_concurrent_builds_leave_one_library(lib, tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    results, errors = [], []

    def build():
        try:
            results.append(native_loader.build_library())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(results)) == 1 and results[0].exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [results[0].name]


def test_ogg_opus_bytes_equal_the_jax_encoder(lib):
    if ctypes.util.find_library("opus") is None:
        pytest.skip("no libopus here: the encoder has nothing to call")
    from matcha_tpu.utils import opus_converter as jax_opus
    from matcha_tpu_torch.utils import opus_converter

    assert opus_converter._load()._name == str(native_loader.library_path())
    wav = (np.random.default_rng(9).standard_normal(24000) * 0.3).astype(np.float32)
    got = opus_converter.waveform_to_opus_ogg(wav)
    assert got[:4] == b"OggS" and got == jax_opus.waveform_to_opus_ogg(wav)


def test_encoder_names_a_missing_libopus(monkeypatch):
    from matcha_tpu_torch.utils import opus_converter

    class NoOpus:  # the C encoder's answer when dlopen finds no libopus
        @staticmethod
        def mtpu_opus_ogg_encode(*args):
            return -1

    monkeypatch.setattr(opus_converter, "_load", lambda: NoOpus())
    with pytest.raises(RuntimeError, match="opus encode failed: -1 .*libopus"):
        opus_converter.waveform_to_opus_ogg(np.zeros(480, np.float32))
