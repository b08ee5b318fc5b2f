"""Convert a reference (PyTorch Lightning) Matcha-TTS-24k checkpoint into
the flat checkpoint directory that the port and the JAX package serve.

Usage:
    python -m matcha_tpu_torch.convert_matcha_ckpt --input checkpoint.ckpt --output ckpt_dir [--strict]

The port's counterpart of ``tools/convert_matcha_ckpt.py``, with no JAX.
Reads ``{"state_dict", "hyper_parameters"}`` (the reference's
hparams-in-checkpoint contract, matcha/inference.py:186-197).  The port's
``MatchaTTS`` carries the reference's own parameter names and layouts, so
the state_dict loads into it as it is, once ``._orig_mod`` segments
(torch.compile wrappers) are stripped and the ``mel_mean``/``mel_std``
buffers left out; any other tensor the model does not have is reported
(``--strict``: refused).  The model's config comes from the hparams
(``config_from_hparams``).  The directory written holds ``config.json``
and ``state.npz`` with ``['params']`` in the flax layout
(``weights.params_to_jax``) and ``['step']`` = 0, which
``checkpoint.load_checkpoint``, ``load_synthesizer`` and the server read.

The checkpoint is read with ``torch.load(..., weights_only=False)``: the
hparams are pickled Python objects (namespaces, omegaconf configs), which
the weights-only unpickler refuses.  That runs code from the file, so
convert only checkpoints from a source you trust.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from matcha_tpu_torch.models.config import (
    CFMConfig,
    DataStatistics,
    DecoderConfig,
    DurationPredictorConfig,
    EncoderConfig,
    MatchaConfig,
)
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.train.checkpoint import save_tree
from matcha_tpu_torch.weights import matcha_param_table, params_to_jax, style_params_to_jax

# buffers of the reference model that hold no learned weight
STATISTICS_PREFIXES = ("mel_mean", "mel_std")


def _get(obj, key, default=None):
    """Field access across the hyper_parameters representations Lightning
    checkpoints carry in the wild: plain dicts, argparse.Namespace-likes,
    and omegaconf DictConfigs (all attribute- or item-accessible)."""
    if obj is None:
        return default
    if isinstance(obj, dict):
        return obj.get(key, default)
    try:
        return getattr(obj, key)
    except AttributeError:
        try:
            return obj[key]
        except Exception:
            return default


def config_from_hparams(hp) -> MatchaConfig:
    """Rebuild the full ``MatchaConfig`` from a checkpoint's
    ``hyper_parameters`` (field names per the reference's matcha_tts.py:17-31
    and configs/model/*); empty hparams give the production config."""
    base = MatchaConfig()
    enc_wrap = _get(hp, "encoder")
    ep = _get(enc_wrap, "encoder_params")
    dpp = _get(enc_wrap, "duration_predictor_params")
    dec = _get(hp, "decoder")
    cfm = _get(hp, "cfm")
    stats = _get(hp, "data_statistics") or {}

    n_feats = int(_get(hp, "n_feats", base.n_feats))
    encoder = EncoderConfig(
        n_feats=int(_get(ep, "n_feats", n_feats)),
        n_channels=int(_get(ep, "n_channels", base.encoder.n_channels)),
        filter_channels=int(_get(ep, "filter_channels", base.encoder.filter_channels)),
        n_heads=int(_get(ep, "n_heads", base.encoder.n_heads)),
        n_layers=int(_get(ep, "n_layers", base.encoder.n_layers)),
        kernel_size=int(_get(ep, "kernel_size", base.encoder.kernel_size)),
        p_dropout=float(_get(ep, "p_dropout", base.encoder.p_dropout)),
        prenet=bool(_get(ep, "prenet", True)),
        prenet_kernel_size=int(_get(ep, "prenet_kernel_size", base.encoder.prenet_kernel_size)),
        # fixed at 6 in the reference (text_encoder.py:343)
        prenet_layers=base.encoder.prenet_layers,
    )
    duration_predictor = DurationPredictorConfig(
        filter_channels=int(_get(dpp, "filter_channels_dp", base.duration_predictor.filter_channels)),
        kernel_size=int(_get(dpp, "kernel_size", base.duration_predictor.kernel_size)),
        p_dropout=float(_get(dpp, "p_dropout", base.duration_predictor.p_dropout)),
        n_layers=int(_get(dpp, "n_layers", base.duration_predictor.n_layers)),
    )
    decoder = DecoderConfig(
        channels=tuple(int(c) for c in (_get(dec, "channels") or base.decoder.channels)),
        dropout=float(_get(dec, "dropout", base.decoder.dropout)),
        attention_head_dim=int(_get(dec, "attention_head_dim", base.decoder.attention_head_dim)),
        n_blocks=int(_get(dec, "n_blocks", base.decoder.n_blocks)),
        num_mid_blocks=int(_get(dec, "num_mid_blocks", base.decoder.num_mid_blocks)),
        num_heads=int(_get(dec, "num_heads", base.decoder.num_heads)),
    )
    cfm_cfg = CFMConfig(
        solver=str(_get(cfm, "solver", base.cfm.solver)),
        sigma_min=float(_get(cfm, "sigma_min", base.cfm.sigma_min)),
        use_mu_prior=bool(_get(cfm, "use_mu_prior", base.cfm.use_mu_prior)),
    )
    return MatchaConfig(
        n_spks=int(_get(hp, "n_spks", base.n_spks)),
        n_feats=n_feats,
        spk_emb_dim=int(_get(hp, "spk_emb_dim", base.spk_emb_dim)),
        encoder=encoder,
        duration_predictor=duration_predictor,
        decoder=decoder,
        cfm=cfm_cfg,
        data_statistics=DataStatistics(
            mel_mean=float(_get(stats, "mel_mean", -4.684777)),
            mel_std=float(_get(stats, "mel_std", 6.512275)),
        ),
        prior_loss=bool(_get(hp, "prior_loss", True)),
        prior_loss_threshold=float(_get(hp, "prior_loss_threshold", base.prior_loss_threshold)),
        duration_loss_threshold=float(_get(hp, "duration_loss_threshold", base.duration_loss_threshold)),
    )


def reference_state_dict(state_dict, cfg: MatchaConfig, strict: bool = False) -> dict[str, torch.Tensor]:
    """A Lightning ``state_dict`` → the port's ``MatchaTTS`` state_dict
    (fp32, CPU): ``._orig_mod`` stripped, ``mel_mean``/``mel_std`` left
    out.  Tensors the model does not have are printed, or raise
    ``ValueError`` with ``strict``; a parameter the model needs and the
    checkpoint lacks raises ``KeyError``."""
    sd = {k.replace("._orig_mod", ""): torch.as_tensor(v).detach().float().cpu() for k, v in state_dict.items()}
    names = [name for name, _, _ in matcha_param_table(cfg)]
    missing = [n for n in names if n not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters (first 10): {missing[:10]}")
    known = set(names)
    leftovers = [k for k in sd if k not in known and not k.startswith(STATISTICS_PREFIXES)]
    if leftovers:
        msg = f"{len(leftovers)} unconverted tensors (first 10): {leftovers[:10]}"
        if strict:
            raise ValueError(msg)
        print(f"[!] {msg}")
    return {n: sd[n] for n in names}


def convert_state_dict(state_dict, cfg: MatchaConfig, strict: bool = False) -> dict:
    """A Lightning ``state_dict`` → the MatchaTTS flax param tree (fp32
    numpy).  It goes through the port's ``MatchaTTS`` with ``strict=True``,
    so every name and shape is the model's."""
    model = MatchaTTS(cfg)
    model.load_state_dict(reference_state_dict(state_dict, cfg, strict), strict=True)
    return params_to_jax(model.state_dict(), cfg)


def convert_checkpoint(ckpt: dict, strict: bool = False) -> tuple[dict, MatchaConfig]:
    """A loaded Lightning checkpoint → (the tree ``{"params", "step"}`` a
    flat checkpoint holds, its config from the hparams)."""
    cfg = config_from_hparams(ckpt.get("hyper_parameters", {}))
    return {"params": convert_state_dict(ckpt["state_dict"], cfg, strict), "step": np.asarray(0)}, cfg


def convert_style_encoder_state_dict(sd, n_layers: int = 4) -> dict:
    """Reference StyleEncoder state_dict → the flax tree of a
    ``style_params.pkl`` (``weights.style_params_from_jax`` reads it).

    Layout (reference: matcha/models/style_encoder.py:49-57): ``convs.{i}``
    Conv1d(k=5) stack + ``proj_enc``/``proj_dur`` linear heads, onto the
    port's ``conv{i}`` / ``head_enc`` / ``head_dur``.  ``style_encoder.`` /
    ``_orig_mod.`` prefixes (LightningModule nesting, torch.compile) are
    stripped; the frozen MatchaTTS's ``matcha.*`` tensors beside it are
    left out."""
    sd = {
        k.replace("._orig_mod", "").removeprefix("style_encoder."): v
        for k, v in sd.items()
        if not k.startswith("matcha.")  # frozen MatchaTTS lives alongside
    }
    names = {f"convs.{i}.{p}": f"conv{i}.{p}" for i in range(n_layers) for p in ("weight", "bias")}
    names.update({f"proj_{h}.{p}": f"head_{h}.{p}" for h in ("enc", "dur") for p in ("weight", "bias")})
    return style_params_to_jax({dst: torch.as_tensor(sd[src]) for src, dst in names.items()})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--strict", action="store_true",
                        help="fail on unconverted tensors instead of warning")
    args = parser.parse_args(argv)

    ckpt = torch.load(args.input, map_location="cpu", weights_only=False)
    tree, cfg = convert_checkpoint(ckpt, strict=args.strict)
    save_tree(args.output, tree, cfg)
    print(
        f"converted → {args.output} "
        f"(enc {cfg.encoder.n_channels}ch×{cfg.encoder.n_layers}L, "
        f"dec {cfg.decoder.channels}, n_spks={cfg.n_spks})"
    )


if __name__ == "__main__":
    main()
