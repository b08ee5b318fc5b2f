"""Convert `charactr/vocos-mel-24khz` torch weights into the Vocos parameter
pickle that the port and the JAX package serve.

Usage:
    python -m matcha_tpu_torch.convert_vocos --input pytorch_model.bin --output vocos.pkl
    python -m matcha_tpu_torch.convert_vocos --verify vocos.pkl [--device cpu]

The port's counterpart of ``tools/convert_vocos.py``, with no JAX.  Input:
the HF torch state dict (``Vocos.from_pretrained`` weights the reference
loads at run time, matcha/vocos24k/vocos_wrapper.py:11).  The port's
``Vocos`` carries the HF names and layouts, so the dict needs only the
clean-ups that real checkpoints call for: wrapper prefixes (``model.``,
``module.``, ``_orig_mod.``) stripped, weight norm folded (the
``parametrizations.weight.original0/1`` style and the old ``weight_g`` /
``weight_v`` one), the mel frontend (``feature_extractor.*``) and the
ISTFT window buffer (``head.istft.*``) left out.  The ConvNeXt depth and
the ``VocosConfig`` are read off the keys and shapes.  A missing key, an
unexpected one or a parametrization without its partner raises with its
name.  The output is the flax-layout tree of numpy arrays
(``weights.vocos_params_to_jax``), pickled, which
``checkpoint.load_vocos`` reads.

``--pretrained`` downloads the HF file (needs ``huggingface_hub`` and a
network).  ``--verify`` holds a converted pickle against the torch
``vocos`` package's decoder, where that package is installed.
"""

from __future__ import annotations

import argparse
import difflib
import pickle
import re

import numpy as np
import torch

from matcha_tpu_torch.vocoder.vocos import VocosConfig
from matcha_tpu_torch.weights import vocos_param_table, vocos_params_to_jax

# keys that real HF Vocos checkpoints carry beside the weights: the mel
# frontend (the port has its own) and the ISTFT window buffer (recomputed)
IGNORABLE_PREFIXES = ("feature_extractor.", "head.istft.")
# wrapper prefixes torch training/compilation utilities prepend to every key
WRAPPER_PREFIXES = ("model.", "module.", "_orig_mod.")


def strip_wrapper_prefixes(sd: dict) -> dict:
    """Strip `model.` / `module.` / `_orig_mod.` wrappers (DataParallel,
    torch.compile, lightning exports) when EVERY key carries one."""
    changed = True
    while changed:
        changed = False
        for p in WRAPPER_PREFIXES:
            if sd and all(k.startswith(p) for k in sd):
                sd = {k[len(p):]: v for k, v in sd.items()}
                changed = True
    return sd


def fold_weight_norm(sd: dict) -> dict:
    """Fold torch weight-norm layouts into plain ``<module>.weight`` keys.

    New style (``torch.nn.utils.parametrize``):
        <m>.parametrizations.weight.original0  (g, the magnitude)
        <m>.parametrizations.weight.original1  (v, the direction)
    Old style (``torch.nn.utils.weight_norm``): ``<m>.weight_g`` + ``<m>.weight_v``.

    Both mean weight = g * v / ||v|| with the norm over every dim but 0
    (weight_norm's default dim=0, which vocos' ConvNeXt uses).
    """

    def folded(g: np.ndarray, v: np.ndarray) -> np.ndarray:
        g = g.reshape(g.shape[0], *([1] * (v.ndim - 1)))
        norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
        return (g * v / norm).astype(v.dtype)

    out: dict = {}
    consumed: set[str] = set()
    for k, g in sd.items():
        m = re.match(r"(.+)\.parametrizations\.(\w+)\.original0$", k)
        if m:
            base, pname = m.groups()
            partner = f"{base}.parametrizations.{pname}.original1"
            if partner not in sd:
                raise KeyError(f"weight-norm parametrization {k!r} has no {partner!r}")
            out[f"{base}.{pname}"] = folded(g, sd[partner])
            consumed.update((k, partner))
            continue
        m = re.match(r"(.+)\.weight_g$", k)
        if m and f"{m.group(1)}.weight_v" in sd:
            out[f"{m.group(1)}.weight"] = folded(g, sd[f"{m.group(1)}.weight_v"])
            consumed.update((k, f"{m.group(1)}.weight_v"))
    for k, v in sd.items():
        if k not in consumed:
            out[k] = v
    return out


def _require(sd: dict, key: str) -> np.ndarray:
    if key not in sd:
        near = difflib.get_close_matches(key, sd.keys(), n=3, cutoff=0.4)
        raise KeyError(f"state dict is missing {key!r}" + (f"; closest present keys: {near}" if near else ""))
    return sd[key]


def vocos_config_from_state_dict(sd: dict, num_layers: int | None = None) -> VocosConfig:
    """The widths of a cleaned-up Vocos state dict: embed (dim, n_mels, 7),
    pwconv1 (intermediate, dim), head.out (n_fft + 2, dim), and the number
    of ``backbone.convnext.<i>`` blocks unless ``num_layers`` is given."""
    if num_layers is None:
        idx = [int(m.group(1)) for k in sd if (m := re.match(r"backbone\.convnext\.(\d+)\.", k))]
        if not idx:
            raise KeyError("no backbone.convnext.<i>.* keys found — is this a Vocos "
                           f"state dict?  sample keys: {sorted(sd)[:5]}")
        num_layers = max(idx) + 1
    dim, n_mels, _ = _require(sd, "backbone.embed.weight").shape
    return VocosConfig(
        input_channels=int(n_mels),
        dim=int(dim),
        intermediate_dim=int(_require(sd, "backbone.convnext.0.pwconv1.weight").shape[0]),
        num_layers=num_layers,
        n_fft=int(_require(sd, "head.out.weight").shape[0] - 2),
    )


def vocos_state_dict(sd: dict, num_layers: int | None = None) -> tuple[dict[str, torch.Tensor], VocosConfig]:
    """An HF Vocos state dict (any layout above) → the port's ``Vocos``
    state dict (fp32 CPU tensors) and its config."""
    sd = fold_weight_norm(strip_wrapper_prefixes({k: np.asarray(v) for k, v in sd.items()}))
    cfg = vocos_config_from_state_dict(sd, num_layers)
    names = [name for name, _, _ in vocos_param_table(cfg)]
    state = {name: torch.from_numpy(np.asarray(_require(sd, name), np.float32)) for name in names}
    known = set(names)
    leftover = sorted(k for k in sd if k not in known and not k.startswith(IGNORABLE_PREFIXES))
    if leftover:
        raise ValueError(
            "unexpected state-dict keys were not converted (Vocos layout "
            f"change?): {leftover[:10]}"
            + (f" … and {len(leftover) - 10} more" if len(leftover) > 10 else "")
        )
    return state, cfg


def convert_vocos_state_dict(sd: dict, num_layers: int | None = None) -> dict:
    """An HF Vocos state dict → the flax-layout tree of the Vocos pickle."""
    state, cfg = vocos_state_dict(sd, num_layers)
    return vocos_params_to_jax(state, cfg)


def verify(pkl_path: str, device=None, atol: float = 1e-3) -> float:
    """The port's Vocos on a converted pickle against the torch ``vocos``
    package's decoder on 4 random mels: max |Δ| of the waveforms.  Needs
    that package and its pretrained weights."""
    from matcha_tpu_torch.checkpoint import load_vocos
    from matcha_tpu_torch.inference import resolve_device
    from matcha_tpu_torch.vocoder.vocos import Vocos

    try:
        from vocos import Vocos as TorchVocos
    except ImportError:
        raise SystemExit("--verify needs the torch `vocos` package, which is not installed here: "
                         "nothing to compare against") from None
    device = resolve_device(device)
    tv = TorchVocos.from_pretrained("charactr/vocos-mel-24khz").eval()
    state, cfg = load_vocos(pkl_path)
    port = Vocos(cfg)
    port.load_state_dict(state)
    port.to(device).eval()
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(4):
        mel = rng.standard_normal((1, cfg.input_channels, 120)).astype(np.float32) * 2.0 - 4.0
        with torch.no_grad():
            ref = tv.decode(torch.from_numpy(mel)).numpy()
            out = port(torch.from_numpy(mel).transpose(1, 2).to(device)).cpu().numpy()
        worst = max(worst, float(np.abs(out[:, : ref.shape[-1]] - ref).max()))
    status = "OK" if worst < atol else "FAIL"
    print(f"verify vs torch vocos: max|Δ| = {worst:.2e} [{status}]")
    if worst >= atol:
        raise SystemExit(1)
    return worst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", help="local HF torch state-dict file")
    parser.add_argument("--pretrained", help="HF repo id to download instead of --input, "
                        "e.g. charactr/vocos-mel-24khz (needs a network)")
    parser.add_argument("--output")
    parser.add_argument("--verify", metavar="VOCOS_PKL",
                        help="compare a converted pkl against the torch vocos package and exit")
    parser.add_argument("--device", default=None, help="--verify's device; default: the CUDA card")
    args = parser.parse_args(argv)

    if args.verify:
        verify(args.verify, args.device)
        return
    if not args.output or not (args.input or args.pretrained):
        parser.error("--output plus one of --input/--pretrained is required")

    src = args.input
    if args.pretrained:
        from huggingface_hub import hf_hub_download

        src = hf_hub_download(repo_id=args.pretrained, filename="pytorch_model.bin")
    sd = torch.load(src, map_location="cpu", weights_only=True)
    params = convert_vocos_state_dict({k: v.float().numpy() for k, v in sd.items()})
    with open(args.output, "wb") as f:
        pickle.dump(params, f)
    print(f"converted vocos weights → {args.output}")


if __name__ == "__main__":
    main()
