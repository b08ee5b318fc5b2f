"""Add a new speaker to a checkpoint via StyleEncoder-predicted embeddings.

CLI:  python -m matcha_tpu_torch.add_speaker \
          --checkpoint_path <matcha ckpt> --style_params style_params.pkl \
          --wav_dir new_speaker_wavs/ --output <new ckpt dir> [--device cpu]

The port's counterpart of ``matcha_tpu/add_speaker.py``: the fine (hop
128) log-mel of every recording, normalized with the checkpoint's
``data_statistics``, goes through the StyleEncoder with a mask of ones;
the (enc, dur) predictions are averaged and appended as a new row of both
speaker tables (and zero rows of any Adam moments) in a copy of the
checkpoint with ``n_spks`` + 1, which ``checkpoint.load_synthesizer``
serves.  ``style_params.pkl`` is the flax-layout pickle either package's
``train_style_encoder`` writes; unpickle only files that tool wrote.  Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from matcha_tpu_torch.checkpoint import load_checkpoint
from matcha_tpu_torch.inference import resolve_device, strict_fp32
from matcha_tpu_torch.models.style_encoder import StyleEncoder
from matcha_tpu_torch.train.checkpoint import add_speaker_rows, save_tree
from matcha_tpu_torch.utils.audio_io import read_wav
from matcha_tpu_torch.utils.model_math import normalize
from matcha_tpu_torch.weights import style_params_from_jax


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--style_params", required=True)
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    strict_fp32(device)
    tree, cfg = load_checkpoint(args.checkpoint_path)
    with open(args.style_params, "rb") as f:
        style_state = style_params_from_jax(pickle.load(f))
    style = StyleEncoder(cfg.n_feats, cfg.spk_emb_dim)
    style.load_state_dict(style_state)
    style.to(device).eval()

    # the StyleEncoder reads fine (hop-128) mels at the model's mel width
    mel_cfg = MelConfig(n_mels=cfg.n_feats).fine
    stats = cfg.data_statistics
    wavs = sorted(Path(args.wav_dir).glob("*.wav"))
    if not wavs:
        raise SystemExit(f"No wavs in {args.wav_dir}")
    enc_rows, dur_rows = [], []
    with torch.no_grad():
        for wav_path in wavs:
            wav, sr = read_wav(wav_path)
            if sr != mel_cfg.sample_rate:
                raise SystemExit(f"{wav_path}: sample rate {sr} != {mel_cfg.sample_rate}")
            mel = log_mel_spectrogram(torch.from_numpy(wav).to(device), mel_cfg)
            mel = normalize(mel, stats.mel_mean, stats.mel_std)[None]
            enc, dur = style(mel, torch.ones(mel.shape[:2], device=device))
            enc_rows.append(enc[0].cpu().numpy())
            dur_rows.append(dur[0].cpu().numpy())

    tree2, cfg2 = add_speaker_rows(tree, cfg, np.mean(enc_rows, axis=0), np.mean(dur_rows, axis=0))
    save_tree(args.output, tree2, cfg2)
    print(f"added speaker {cfg.n_spks} (from {len(wavs)} recordings) → {args.output}")


if __name__ == "__main__":
    main()
