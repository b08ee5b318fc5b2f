"""Strip a training checkpoint to params-only for serving/release.

CLI:  python -m matcha_tpu_torch.utils.prepare_ckpt_for_release \
          --input <ckpt_dir> --output docker/checkpoint

The port's counterpart of ``matcha_tpu/utils/prepare_ckpt_for_release.py``
on flat checkpoints: drops the optimizer state, keeps the params, the step
and the config.  Host-side numpy: no device is involved.
"""

from __future__ import annotations

import argparse

from matcha_tpu_torch.checkpoint import load_checkpoint
from matcha_tpu_torch.train.checkpoint import save_tree, strip_for_release


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    tree, cfg = load_checkpoint(args.input)
    save_tree(args.output, strip_for_release(tree), cfg)
    print(f"stripped checkpoint → {args.output}")


if __name__ == "__main__":
    main()
