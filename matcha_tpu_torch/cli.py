"""Synthesis CLI: ``python -m matcha_tpu_torch.cli --text ... --spk 0,1``.

The port's counterpart of ``matcha_tpu/cli.py``, same arguments plus
``--device``: writes ``speaker_NNN.wav`` (and a best-effort ``.mp3``),
prints one ``[+] ... RTF=`` line per speaker; ``--debug`` also writes the
per-phoneme durations (``_durations.tsv``) and the encoder prior vocoded
(``_encoder.wav``).  ``--checkpoint_path`` is a flat checkpoint directory
(``config.json`` + ``state.npz``), ``--vocoder_path`` a Vocos parameter
pickle.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from matcha_tpu_torch.checkpoint import load_synthesizer
from matcha_tpu_torch.inference import (
    DEFAULT_NUM_STEPS,
    DEFAULT_ODE_SOLVER,
    SAMPLE_RATE,
    VOICES,
    voice_by_id,
)
from matcha_tpu_torch.utils.audio_io import write_wav


def main(argv=None):
    parser = argparse.ArgumentParser(description="MatchaTTS-24k synthesis with PyTorch")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--text")
    group.add_argument(
        "--phoneme_ids",
        help="comma-separated pretokenized IDs (skips the eSpeak frontend)",
    )
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--vocoder_path", default=None, help="converted Vocos params pickle")
    parser.add_argument("--spk", default="0", help="comma-separated speaker ids")
    parser.add_argument("--steps", type=int, default=DEFAULT_NUM_STEPS)
    parser.add_argument("--solver", default=DEFAULT_ODE_SOLVER)
    parser.add_argument("--length_scale", type=float, default=1.0)
    parser.add_argument("--output_dir", default=".")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    synth = load_synthesizer(args.checkpoint_path, args.vocoder_path, device=args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    for spk_str in args.spk.split(","):
        spk = int(spk_str)
        kwargs = dict(
            speaker=spk,
            n_timesteps=args.steps,
            solver=args.solver,
            length_scale=args.length_scale,
            debug=args.debug,
        )
        if args.text is not None:
            result = synth.synthesise(args.text, **kwargs)
        else:
            ids = [int(t) for t in args.phoneme_ids.split(",")]
            result = synth.synthesise_ids(ids, **kwargs)
        name = f"speaker_{spk:03d}"
        if len(result.wav):
            write_wav(out_dir / f"{name}.wav", result.wav, SAMPLE_RATE)
            try:
                from matcha_tpu_torch.utils.mp3_converter import waveform_to_mp3

                (out_dir / f"{name}.mp3").write_bytes(waveform_to_mp3(result.wav))
            except Exception as exc:  # mp3 is best-effort: the wav is the result
                print(f"[!] mp3 encode failed: {exc}", file=sys.stderr)
        if args.debug and result.durations is not None:
            with open(out_dir / f"{name}_durations.tsv", "w") as f:
                for i, d in enumerate(result.durations):
                    f.write(f"{i}\t{float(d):.2f}\n")
        if args.debug and result.encoder_wav is not None:
            write_wav(out_dir / f"{name}_encoder.wav", result.encoder_wav, SAMPLE_RATE)
        voice = voice_by_id(spk)["name"] if spk < len(VOICES) else str(spk)
        print(f"[+] {name} ({voice}): {len(result.wav)/SAMPLE_RATE:.2f}s  RTF={result.rtf:.4f}")


if __name__ == "__main__":
    main()
