"""Weight bridge between the JAX package's parameter trees and the port's state_dicts.

The port's modules carry the reference Matcha-TTS / Vocos torch names, so a
state_dict here is the reference torch layout, and the JAX package's
converters (``tools/convert_matcha_ckpt.py::convert_state_dict``,
``tools/convert_vocos.py::convert_vocos_state_dict``) map it straight back
to the flax tree.  This module is their inverse, written from the same
layout rules (and importing neither):

  flax Conv kernel (k, in, out)          → torch Conv1d (out, in, k)
  flax Dense kernel (in, out)            → torch Linear (out, in)
  flax Dense kernel (in, out)            → torch kernel-1 Conv1d (out, in, 1)
  flax ConvTranspose(transpose_kernel)   → torch ConvTranspose1d (in, out, k)
    kernel (k, out, in)
  flax depthwise Conv (k, 1, dim)        → torch Conv1d groups=dim (dim, 1, k)
  flax Embed / norm scale, bias          → as is

Each mapping is one row of a table built from the config; a flax leaf that
no row consumes, or a row whose leaf is missing, raises.  ``params_to_jax``
runs the same table backwards (the trainer writes its checkpoints in the
flax layout, and the tests hold gradients against ``jax.grad``), as do
``vocos_params_to_jax`` (the Vocos pickle the tools read) and
``style_params_to_jax`` (a ``style_params.pkl``, read back by
``style_params_from_jax``), and
``decay_mask`` reads weight decay off the layout kind: the rows that are
flax ``kernel``s decay, the ``copy`` rows (embeddings, norm scales and
biases, biases, SnakeBeta alpha/beta) do not.

F5-TTS's DiT (``models/dit.py``) and CosyVoice 2's flow stage
(``models/cosyflow.py``) have no flax layout: their tables
(``F5TTS.param_table``, ``CosyFlow.param_table``) nest the torch names by
their dots, in the kind ``torch`` (kept as it is, and decayed), so their
checkpoints keep the trainer's format and key paths, and every one of
their leaves decays.
``param_table`` asks the class a config builds for its table.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from matcha_tpu_torch.models.config import DiTConfig, MatchaConfig
from matcha_tpu_torch.vocoder.vocos import VocosConfig

_TO_TORCH = {
    "copy": lambda w: w,
    "torch": lambda w: w,
    "conv": lambda w: np.transpose(w, (2, 1, 0)),
    "dense": lambda w: w.T,
    "dense_as_conv1x1": lambda w: w.T[:, :, None],
    "convT": lambda w: np.transpose(w, (2, 1, 0)),
}


_TO_FLAX = {
    "copy": lambda w: w,
    "torch": lambda w: w,
    "conv": lambda w: np.transpose(w, (2, 1, 0)),
    "dense": lambda w: w.T,
    "dense_as_conv1x1": lambda w: w[:, :, 0].T,
    "convT": lambda w: np.transpose(w, (2, 1, 0)),
}


class _Table:
    def __init__(self):
        self.rows: list[tuple[str, str, str]] = []  # (torch name, flax path, kind)

    def add(self, torch_name: str, flax_path: str, kind: str = "copy"):
        self.rows.append((torch_name, flax_path, kind))

    def layer(self, torch_base: str, flax_base: str, kind: str, bias: bool = True):
        self.add(f"{torch_base}.weight", f"{flax_base}/kernel", kind)
        if bias:
            self.add(f"{torch_base}.bias", f"{flax_base}/bias")

    def norm(self, torch_base: str, flax_base: str, names=("weight", "bias")):
        w, b = names
        self.add(f"{torch_base}.{w}", f"{flax_base}/{'gamma' if w == 'gamma' else 'scale'}")
        self.add(f"{torch_base}.{b}", f"{flax_base}/{'beta' if b == 'beta' else 'bias'}")


def matcha_param_table(cfg: MatchaConfig) -> list[tuple[str, str, str]]:
    """(torch name, flax path, layout kind) for every MatchaTTS parameter."""
    t = _Table()
    for tab in ("speaker_embeddings_enc", "speaker_embeddings_dur"):
        t.add(f"{tab}.weight", f"{tab}/embedding")

    enc = cfg.encoder
    t.add("encoder.emb.weight", "encoder/emb/embedding")
    ln = ("gamma", "beta")
    if enc.prenet:
        n = enc.prenet_layers
        for i in range(n):
            t.layer(f"encoder.prenet.conv_layers.{i}", f"encoder/prenet/Conv_{i}", "conv")
            t.norm(f"encoder.prenet.norm_layers.{i}", f"encoder/prenet/ChannelLayerNorm_{i}", ln)
        t.layer("encoder.prenet.proj", f"encoder/prenet/Conv_{n}", "conv")
    for i in range(enc.n_layers):
        src, dst = f"encoder.encoder.attn_layers.{i}", f"encoder/encoder/RopeSelfAttention_{i}"
        for s, d in (("conv_q", "q"), ("conv_k", "k"), ("conv_v", "v"), ("conv_o", "out")):
            t.layer(f"{src}.{s}", f"{dst}/{d}", "dense_as_conv1x1")
        t.norm(f"encoder.encoder.norm_layers_1.{i}", f"encoder/encoder/ChannelLayerNorm_{2 * i}", ln)
        t.norm(f"encoder.encoder.norm_layers_2.{i}", f"encoder/encoder/ChannelLayerNorm_{2 * i + 1}", ln)
        t.layer(f"encoder.encoder.ffn_layers.{i}.conv_1", f"encoder/encoder/ConvFFN_{i}/Conv_0", "conv")
        t.layer(f"encoder.encoder.ffn_layers.{i}.conv_2", f"encoder/encoder/ConvFFN_{i}/Conv_1", "conv")
    t.layer("encoder.proj_m.0", "encoder/proj_m_hidden", "conv")
    t.layer("encoder.proj_m.2", "encoder/proj_m_out", "conv")
    t.layer("encoder.proj_w.spk_proj", "encoder/proj_w/spk_proj", "dense")
    n = cfg.duration_predictor.n_layers
    for i in range(n):
        t.layer(f"encoder.proj_w.conv_layers.{i}", f"encoder/proj_w/Conv_{i}", "conv")
        t.norm(f"encoder.proj_w.norm_layers.{i}", f"encoder/proj_w/ChannelLayerNorm_{i}", ln)
    t.layer("encoder.proj_w.proj", f"encoder/proj_w/Conv_{n}", "conv")

    dec = "decoder.estimator"
    t.layer(f"{dec}.time_mlp.linear_1", "decoder/time_mlp/linear_1", "dense")
    t.layer(f"{dec}.time_mlp.linear_2", "decoder/time_mlp/linear_2", "dense")

    def resnet(src, dst):
        t.layer(f"{src}.mlp.1", f"{dst}/time_proj", "dense")
        for blk in ("block1", "block2"):
            t.layer(f"{src}.{blk}.block.0", f"{dst}/{blk}/Conv_0", "conv")
            t.norm(f"{src}.{blk}.block.1", f"{dst}/{blk}/GroupNorm_0")
        t.layer(f"{src}.res_conv", f"{dst}/res_conv", "conv")

    def tblocks(src, dst):
        for b in range(cfg.decoder.n_blocks):
            s, d = f"{src}.{b}", f"{dst}_tblock{b}"
            if cfg.decoder.block_type == "conformer":
                conformer(s, d)
                continue
            t.norm(f"{s}.norm1", f"{d}/norm1")
            t.norm(f"{s}.norm3", f"{d}/norm3")
            for proj in ("to_q", "to_k", "to_v"):
                t.layer(f"{s}.attn1.{proj}", f"{d}/{proj}", "dense", bias=False)
            t.layer(f"{s}.attn1.to_out.0", f"{d}/to_out", "dense")
            t.layer(f"{s}.ff.net.0.proj", f"{d}/ff/proj_in", "dense")
            t.add(f"{s}.ff.net.0.alpha", f"{d}/ff/alpha")
            t.add(f"{s}.ff.net.0.beta", f"{d}/ff/beta")
            t.layer(f"{s}.ff.net.2", f"{d}/ff/proj_out", "dense")

    def conformer(s, d):
        # the port's own submodule names (models/decoder.py::ConformerBlock)
        for norm in ("ff1_norm", "attn_norm", "conv_norm", "ff2_norm", "final_norm"):
            t.norm(f"{s}.{norm}", f"{d}/{norm}")
        for dense in ("ff1_in", "ff1_out", "to_q", "to_k", "to_v", "to_out", "conv_in", "conv_out",
                      "ff2_in", "ff2_out"):
            t.layer(f"{s}.{dense}", f"{d}/{dense}", "dense")
        t.layer(f"{s}.conv_dw", f"{d}/conv_dw", "conv")

    n_down = len(cfg.decoder.channels)
    for i in range(n_down):
        resnet(f"{dec}.down_blocks.{i}.0", f"decoder/down{i}_resnet")
        tblocks(f"{dec}.down_blocks.{i}.1", f"decoder/down{i}")
        if i < n_down - 1:
            t.layer(f"{dec}.down_blocks.{i}.2.conv", f"decoder/down{i}_downsample/Conv_0", "conv")
        else:
            t.layer(f"{dec}.down_blocks.{i}.2", f"decoder/down{i}_conv", "conv")
    for i in range(cfg.decoder.num_mid_blocks):
        resnet(f"{dec}.mid_blocks.{i}.0", f"decoder/mid{i}_resnet")
        tblocks(f"{dec}.mid_blocks.{i}.1", f"decoder/mid{i}")
    for i in range(n_down):
        resnet(f"{dec}.up_blocks.{i}.0", f"decoder/up{i}_resnet")
        tblocks(f"{dec}.up_blocks.{i}.1", f"decoder/up{i}")
        if i < n_down - 1:
            t.layer(f"{dec}.up_blocks.{i}.2.conv", f"decoder/up{i}_upsample/ConvTranspose_0", "convT")
        else:
            t.layer(f"{dec}.up_blocks.{i}.2", f"decoder/up{i}_conv", "conv")
    t.layer(f"{dec}.final_block.block.0", "decoder/final_block/Conv_0", "conv")
    t.norm(f"{dec}.final_block.block.1", "decoder/final_block/GroupNorm_0")
    t.layer(f"{dec}.final_proj", "decoder/final_proj", "conv")
    return t.rows


def style_param_table(n_layers: int = 4) -> list[tuple[str, str, str]]:
    """(torch name, flax path, layout kind) for every StyleEncoder parameter."""
    t = _Table()
    for i in range(n_layers):
        t.layer(f"conv{i}", f"conv{i}", "conv")
    t.layer("head_enc", "head_enc", "dense")
    t.layer("head_dur", "head_dur", "dense")
    return t.rows


def vocos_param_table(cfg: VocosConfig) -> list[tuple[str, str, str]]:
    """(torch name, flax path, layout kind) for every Vocos parameter."""
    t = _Table()
    t.layer("backbone.embed", "backbone/embed", "conv")
    t.norm("backbone.norm", "backbone/norm")
    for i in range(cfg.num_layers):
        s, d = f"backbone.convnext.{i}", f"backbone/convnext{i}"
        t.layer(f"{s}.dwconv", f"{d}/dwconv", "conv")
        t.norm(f"{s}.norm", f"{d}/norm")
        t.layer(f"{s}.pwconv1", f"{d}/pwconv1", "dense")
        t.layer(f"{s}.pwconv2", f"{d}/pwconv2", "dense")
        t.add(f"{s}.gamma", f"{d}/gamma")
    t.norm("backbone.final_layer_norm", "backbone/final_layer_norm")
    t.layer("head.out", "head/out", "dense")
    return t.rows


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays → {"a/b/c": array}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, path + "/"))
        else:
            flat[path] = v
    return flat


def _bridge(tree: Mapping, rows) -> dict[str, torch.Tensor]:
    flat = flatten_tree(tree)
    state = {}
    used = set()
    for torch_name, flax_path, kind in rows:
        if flax_path not in flat:
            raise KeyError(f"parameter tree has no {flax_path!r} (for {torch_name!r})")
        if flax_path in used:
            raise ValueError(f"{flax_path!r} mapped twice")
        used.add(flax_path)
        w = np.asarray(flat[flax_path], dtype=np.float32)
        state[torch_name] = torch.tensor(_TO_TORCH[kind](w))
    leftover = sorted(set(flat) - used)
    if leftover:
        raise ValueError(f"{len(leftover)} parameters not mapped (first 10): {leftover[:10]}")
    return state


def params_from_jax(flax_params: Mapping, cfg: MatchaConfig | DiTConfig) -> dict[str, torch.Tensor]:
    """MatchaTTS flax param tree (the DiT's tree of torch names; numpy
    leaves) → port state_dict (fp32)."""
    return _bridge(flax_params, param_table(cfg))


def vocos_params_from_jax(flax_params: Mapping, cfg: VocosConfig) -> dict[str, torch.Tensor]:
    """Vocos flax param tree (numpy leaves) → port state_dict (fp32)."""
    return _bridge(flax_params, vocos_param_table(cfg))


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b/c": array} → nested dict."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def style_params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """StyleEncoder flax param tree (a ``style_params.pkl``) → port state_dict."""
    n_layers = sum(1 for k in flax_params if k.startswith("conv"))
    return _bridge(flax_params, style_param_table(n_layers))


def _unbridge(state: Mapping[str, torch.Tensor], rows) -> dict:
    names = {r[0] for r in rows}
    if set(state) != names:
        missing, extra = sorted(names - set(state)), sorted(set(state) - names)
        raise KeyError(f"state_dict does not match the table: missing {missing[:10]}, extra {extra[:10]}")
    return unflatten_tree({
        flax_path: np.ascontiguousarray(_TO_FLAX[kind](state[name].detach().float().cpu().numpy()))
        for name, flax_path, kind in rows
    })


def params_to_jax(state: Mapping[str, torch.Tensor], cfg: MatchaConfig | DiTConfig) -> dict:
    """Port state_dict (any device) → MatchaTTS flax param tree (the DiT's
    tree of torch names; fp32 numpy)."""
    return _unbridge(state, param_table(cfg))


def vocos_params_to_jax(state: Mapping[str, torch.Tensor], cfg: VocosConfig) -> dict:
    """Port Vocos state_dict → the flax param tree ``tools/convert_vocos.py``
    pickles (fp32 numpy)."""
    return _unbridge(state, vocos_param_table(cfg))


def style_params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """Port StyleEncoder state_dict → the flax tree of a ``style_params.pkl``
    (conv kernels (k, in, out), dense kernels (in, out))."""
    n_layers = sum(1 for k in state if k.startswith("conv") and k.endswith(".weight"))
    return _unbridge(state, style_param_table(n_layers))


def param_table(cfg: MatchaConfig | DiTConfig) -> list[tuple[str, str, str]]:
    """The parameter table of the model ``cfg`` builds."""
    return cfg.model_class().param_table(cfg)


def decay_mask(cfg: MatchaConfig | DiTConfig) -> dict[str, bool]:
    """torch name → True where AdamW's weight decay applies: every row but
    the ``copy`` ones (MatchaTTS's flax kernels; every leaf of the DiT)."""
    return {name: kind != "copy" for name, _, kind in param_table(cfg)}
