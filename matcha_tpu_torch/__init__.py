"""Matcha-TTS-24k on PyTorch and CUDA: the port of ``matcha_tpu`` to an
NVIDIA H100.

Public API surface:
    matcha_tpu_torch.inference       — MatchaSynthesizer, VOICES
    matcha_tpu_torch.models          — MatchaTTS, configs, random init
    matcha_tpu_torch.weights         — JAX parameter trees → state_dicts
    matcha_tpu_torch.checkpoint      — checkpoint directories → synthesizer
    matcha_tpu_torch.serving.server  — HTTP server + request batcher
    matcha_tpu_torch.audio.mel       — log-mel frontend
    matcha_tpu_torch.train           — Trainer, checkpoints and surgery
    matcha_tpu_torch.parallel        — data and tensor parallelism
    matcha_tpu_torch.convert_matcha_ckpt, .convert_vocos
                                     — the reference's Lightning / HF Vocos
                                       weights → the formats served here
    matcha_tpu_torch.data.native_loader — the C++ batch loader (g++ at first use)

Entry points: ``python -m matcha_tpu_torch.serving.server``,
``python -m matcha_tpu_torch.train``, ``python -m matcha_tpu_torch.cli``,
``finetune_speaker``, ``train_style_encoder``, ``add_speaker`` and the
corpus / checkpoint / MCD / UTMOS / measuring tools under
``matcha_tpu_torch.utils``.  Hand-written
CUDA kernels live under ``ops/csrc`` and build on first use.
"""

__version__ = "0.1.0"
