"""One training step, worked out by the plain fp32 reference.

The published Matcha-TTS objective (duration, prior and CFM losses) and
its optimizer: monotonic alignment search over the fp32 Gaussian
log-prior at hop 128, Huber duration loss on log(2 + d), Huber prior
loss, the OT-CFM loss at hop 256 with the prior detached, each loss over
the weighted count of its valid elements; then global-norm clip and AdamW
(bias-corrected in fp32, decay on every matrix that is not an embedding).

Randomness: a step draws CFM's t and noise from a generator seeded from
(seed, step) and its dropout masks from one seeded from (seed, step, 0),
both on the step's device, as the recipe under test states
(``step_seed``); the draws come in the modules' order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import MatchaTTS, sequence_mask
from benchmark.reference.synthesis import downsample_time

NEG = -1e9


def step_seed(seed: int, step: int, *more: int) -> int:
    words = np.random.SeedSequence([seed, step, *more]).generate_state(2, dtype=np.uint32)
    return int(words[0]) << 32 | int(words[1])


def mas_indices(value, x_len, y_len):
    """(B, Tx, Ty) log-prior → (B, Ty) token of each frame, −1 past y_len.
    Frame by frame: f[i] ← v[i, j] + max(f[i], f[i−1]); ties go diagonal."""
    b, tx, ty = value.shape
    dev = value.device
    rows = torch.arange(tx, device=dev)
    valid = rows[None] < x_len[:, None]
    neg = torch.full((b, 1), NEG, device=dev)
    f = torch.where((rows[None] == 0) & valid, value[:, :, 0], NEG)
    diag = torch.zeros((ty, b, tx), dtype=torch.bool, device=dev)
    for j in range(1, ty):
        shifted = torch.cat([neg, f[:, :-1]], dim=1)
        diag[j] = shifted >= f
        nf = torch.where(valid, value[:, :, j] + torch.maximum(f, shifted), NEG)
        f = torch.where((j < y_len)[:, None], nf, f)
    idx = torch.empty((b, ty), dtype=torch.long, device=dev)
    cur = x_len - 1
    for j in range(ty - 1, -1, -1):
        active = j < y_len
        idx[:, j] = torch.where(active, cur, -1)
        took = diag[j].gather(1, cur.clamp(0, tx - 1)[:, None])[:, 0]
        cur = cur - (active & (j > 0) & (cur > 0) & took).long()
    return idx


def losses(model: MatchaTTS, batch: dict, seed: int, step: int) -> dict:
    """The three losses of one padded batch (dict of x, x_lengths, y,
    y_lengths, y_fine, y_fine_lengths, spks, weights on one device)."""
    cfg = model.cfg
    dev = batch["y"].device
    cfm_gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    drop_gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step, 0))
    x, y, y_fine = batch["x"], batch["y"], batch["y_fine"]
    x_len, y_len, yf_len = batch["x_lengths"].long(), batch["y_lengths"].long(), batch["y_fine_lengths"].long()
    w = batch["weights"].float()
    x_mask = sequence_mask(x_len, x.shape[1]).float()
    y_mask = sequence_mask(y_len, y.shape[1]).float()
    yf_mask = sequence_mask(yf_len, y_fine.shape[1]).float()
    dens = [(x_len * w).sum(), (yf_mask * w[:, None]).sum(), (y_mask * w[:, None]).sum() * y.shape[-1]]

    spk_enc = model.speaker_embeddings_enc(batch["spks"].long())
    spk_dur = model.speaker_embeddings_dur(batch["spks"].long())
    mu_x, logw = model.encoder(x.long(), x_mask, spk_enc, spk_dur, drop_gen)

    with torch.no_grad():
        mu_d = mu_x.detach()
        log_prior = (-0.5 * y_fine.square().sum(-1)[:, None, :]
                     + torch.einsum("bic,bjc->bij", mu_d, y_fine)
                     - 0.5 * mu_d.square().sum(-1)[:, :, None])
        idx = mas_indices(log_prior, x_len, yf_len)
        del log_prior
    durs = torch.zeros((x.shape[0], x.shape[1]), device=dev).scatter_add_(1, idx.clamp(min=0), (idx >= 0).float())
    target = torch.log(2.0 + durs) * x_mask
    dur_loss = (F.huber_loss(logw, target, reduction="none", delta=cfg["duration_loss_threshold"])
                * w[:, None]).sum() / dens[0]

    gidx = idx.clamp(min=0)[:, :, None].expand(-1, -1, mu_x.shape[-1])
    mu_y_fine = torch.gather(mu_x, 1, gidx) * yf_mask[..., None]
    m = yf_mask[..., None]
    prior_loss = (F.huber_loss(mu_y_fine * m, y_fine * m, reduction="none", delta=cfg["prior_loss_threshold"])
                  * w[:, None, None]).sum() / dens[1]

    mu_y = downsample_time(mu_y_fine)[:, : y.shape[1]].detach()
    b = y.shape[0]
    t = torch.rand((b, 1, 1), generator=cfm_gen, device=dev)
    noise = torch.randn(y.shape, generator=cfm_gen, device=dev)
    sigma = cfg["cfm"]["sigma_min"]
    x0 = mu_y + noise
    xt = (1.0 - (1.0 - sigma) * t) * x0 + t * y
    u = y - (1.0 - sigma) * x0
    pred = model.decoder.estimator(xt, y_mask, mu_y, t[:, 0, 0], masked_norm=False, gen=drop_gen)
    sq = torch.square((pred - u) * y_mask[..., None])
    diff_loss = (sq * w[:, None, None]).sum() / dens[2]
    return {"loss": diff_loss + dur_loss + prior_loss, "diff_loss": diff_loss, "dur_loss": dur_loss,
            "prior_loss": prior_loss}


class AdamW:
    """clip_by_global_norm → AdamW, over a {name: tensor} dict."""

    def __init__(self, opt: dict, params: dict):
        self.o = opt
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.decay = {n: p.dim() >= 2 and "emb" not in n.split(".")[-2] for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        o = self.o
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        factor = torch.where(norm < o["grad_clip"], torch.ones_like(norm), o["grad_clip"] / norm)
        self.count += 1
        n = torch.tensor(float(self.count))
        bc1 = float(1.0 - torch.pow(torch.tensor(o["b1"], dtype=torch.float32), n))
        bc2 = float(1.0 - torch.pow(torch.tensor(o["b2"], dtype=torch.float32), n))
        for name, p in params.items():
            g = grads[name] * factor
            self.mu[name] = (1 - o["b1"]) * g + o["b1"] * self.mu[name]
            self.nu[name] = (1 - o["b2"]) * g * g + o["b2"] * self.nu[name]
            u = (self.mu[name] / bc1) / (torch.sqrt(self.nu[name] / bc2) + o["eps"])
            if self.decay[name]:
                u = u + o["weight_decay"] * p
            p.sub_(o["lr"] * u)


def run_steps(cfg: dict, params: dict, batches: list[dict], seed: int, device) -> dict:
    """Train a copy of ``params`` on ``batches`` (one step each, steps 0, 1,
    ...) → each step's losses, the first step's clipped gradient as the
    optimizer took it, and the parameters after the last step (on the CPU)."""
    model = MatchaTTS(cfg["model"]).to(device)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    live = dict(model.named_parameters())
    opt = AdamW(cfg["training"]["optimizer"], live)
    out = {"losses": [], "first_grad": None}
    for step, batch in enumerate(batches):
        batch = {k: v.to(device) for k, v in batch.items()}
        ls = losses(model, batch, seed, step)
        grads = torch.autograd.grad(ls["loss"], list(live.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(live.items(), grads)}
        opt.update(live, grads)
        out["losses"].append({k: float(v.detach()) for k, v in ls.items()})
        if step == 0:
            out["first_grad"] = {n: (m / (1 - opt.o["b1"])).cpu() for n, m in opt.mu.items()}
        del ls, grads
    out["params"] = {n: p.detach().cpu() for n, p in live.items()}
    return out
