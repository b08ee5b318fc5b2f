"""Proof that the port's trainer LEARNS, not just that its mechanics run.

The counterpart of ``tests/test_training_learns.py``: the same structured
batch (each token owns a fixed mel signature and lasts exactly 4 fine
frames, so the duration, prior and CFM losses all have deterministic
targets) is overfit for 400 production ``TrainStep`` steps (clip 4.0,
AdamW 3e-3, ``tiny_config()``, fp32 on the CPU), and each sub-loss must
fall below half its steps-5–15 mean.  A gradient with a flipped sign, or a
kernel's backward that returned zeros, makes a loss rise or stall.  This is
the step that ``utils/profile_step.py`` times.
"""

import numpy as np
import torch

from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep

CFG = tiny_config()
STEPS = 400


def structured_batch(b=4, tx=8, frames_per_token=4, seed=0) -> Batch:
    """``tests/test_training_learns.py::structured_batch``, as torch tensors."""
    rng = np.random.default_rng(seed)
    signatures = rng.standard_normal((600, CFG.n_feats)).astype(np.float32)
    x = rng.integers(1, 600, (b, tx)).astype(np.int64)
    y_fine = signatures[x].repeat(frames_per_token, axis=1)  # (b, tx*fpt, C)
    y = 0.5 * (y_fine[:, 0::2] + y_fine[:, 1::2])  # k2s2 preview of coarse
    tf = tx * frames_per_token
    return Batch(
        x=torch.from_numpy(x),
        x_lengths=torch.full((b,), tx),
        y=torch.from_numpy(y),
        y_lengths=torch.full((b,), tf // 2),
        y_fine=torch.from_numpy(y_fine),
        y_fine_lengths=torch.full((b,), tf),
        spks=torch.from_numpy(np.arange(b) % CFG.n_spks),
    )


def test_overfit_all_sub_losses_descend():
    batch = structured_batch()
    ts = TrainStep(CFG, OptimizerConfig(lr=3e-3, b2=0.999, grad_clip=4.0), device="cpu")
    state = ts.init_state(generator=torch.Generator().manual_seed(0))

    history = {"diff": [], "dur": [], "prior": []}
    for _ in range(STEPS):
        state, m = ts.train_step(state, batch, 42)
        for name, h in history.items():
            h.append(float(m[f"sub_loss/{name}"]))
    history = {k: np.asarray(v) for k, v in history.items()}
    assert all(np.isfinite(h).all() for h in history.values())

    # windows absorb the per-step CFM (t, noise) sampling variance; the
    # JAX test's 50 % bar, which fails on any sign error
    for name, h in history.items():
        baseline = float(h[5:15].mean())
        final = float(h[-20:].mean())
        assert final < 0.5 * baseline, (
            f"sub_loss/{name} did not descend: steps 5-15 mean {baseline:.4f} "
            f"→ last-20 mean {final:.4f}"
        )
