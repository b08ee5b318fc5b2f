"""Uniformly average N checkpoints into one.

CLI:  python -m matcha_tpu_torch.utils.average_checkpoints \
          --inputs ckpt_a ckpt_b ... --output averaged_ckpt

The port's counterpart of ``matcha_tpu/utils/average_checkpoints.py`` on
flat checkpoints (``config.json`` + ``state.npz``): a float64 mean of every
parameter, cast back; the optimizer state and counters are the last
input's.  Host-side numpy: no device is involved.
"""

from __future__ import annotations

import argparse

from matcha_tpu_torch.checkpoint import load_checkpoint
from matcha_tpu_torch.train.checkpoint import average_checkpoints, save_tree


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--inputs", nargs="+", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    trees = []
    cfg = None
    for path in args.inputs:
        tree, cfg = load_checkpoint(path)
        trees.append(tree)
    save_tree(args.output, average_checkpoints(trees), cfg)
    print(f"averaged {len(trees)} checkpoints → {args.output}")


if __name__ == "__main__":
    main()
