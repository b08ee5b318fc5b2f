"""Model hyper-parameter schema with production defaults.

``MatchaConfig`` is the port's own copy of the JAX package's schema, field
for field, so a checkpoint's ``config.json`` reads the same in both.  Plain
frozen dataclasses.  Defaults reproduce the reference production config
(reference: configs/model/*.yaml, configs/data/corpus-24k.yaml).  Serialized
into every checkpoint so inference can rebuild the model without external
config files (reference behaviour: matcha/inference.py:186-197).

``DiTConfig`` is the port's second model, F5-TTS's DiT trained by flow
matching (``models/dit.py``), which the JAX package does not have.  Its
``config.json`` carries ``"arch": "f5tts_dit"``.  ``CosyFlowConfig`` is the
third, CosyVoice 2's streaming flow-matching stage (``models/cosyflow.py``),
with ``"arch": "cosyvoice2_flow"``.  ``model_config_from_dict`` reads any
kind.  Each config's ``model_class()`` names the module it builds.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class EncoderConfig:
    n_feats: int = 100          # imposed by the Vocos-24k mel basis
    n_channels: int = 192
    filter_channels: int = 1152
    n_heads: int = 6            # head dim = (192+96)/6 = 48
    n_layers: int = 4
    kernel_size: int = 5
    p_dropout: float = 0.1
    prenet: bool = True
    prenet_kernel_size: int = 5
    prenet_layers: int = 6
    rope_max_len: int = 4000    # upper bound on tokenized text length
    # torch-autocast semantics under bf16 compute: LayerNorm outputs and
    # residual adds stay fp32, only conv/dense inputs run bf16 (see
    # DecoderConfig.fp32_residual — the encoder matters doubly because the
    # ODE is anchored on mu_x, so encoder rounding propagates straight
    # into the mel).  No-op under fp32 compute.
    fp32_residual: bool = True


@dataclass(frozen=True)
class DurationPredictorConfig:
    filter_channels: int = 128
    kernel_size: int = 5
    p_dropout: float = 0.1
    n_layers: int = 4


@dataclass(frozen=True)
class DecoderConfig:
    channels: tuple[int, ...] = (320, 320)  # >= 2*n_feats + spk_emb_dim
    dropout: float = 0.05
    attention_head_dim: int = 64
    n_blocks: int = 2
    num_mid_blocks: int = 2
    num_heads: int = 5
    act_fn: str = "snakebeta"
    block_type: str = "transformer"  # "transformer" | "conformer"
    # Rematerialize each U-Net block in the backward pass (jax.checkpoint):
    # activation memory drops from all-blocks-live to one-block-live at the
    # cost of one extra forward — the TPU lever for large frame budgets
    # (HBM-bound training).  Numerics are identical (tests pin grads).
    remat: bool = False
    # Compute GroupNorm/LayerNorm statistics in the compute dtype instead
    # of flax's default fp32 promotion.  Only meaningful under bf16; an
    # inference-side speed lever measured by tools/ab_stage_b_levers.py —
    # keep False unless the A/B shows a win AND the on-TPU parity tier
    # (tests/test_tpu_e2e.py) stays under its MCD bar with it on.
    bf16_norm_stats: bool = False
    # Under bf16 compute, keep the U-Net's residual carry (and GroupNorm
    # outputs) in fp32 — torch-autocast semantics: only matmul/conv inputs
    # run bf16; adds, norms, and the stream between blocks stay fp32.  The
    # reference serves under exactly this regime (matcha/inference.py:238
    # wraps synthesise in torch.autocast, which never casts adds/norms),
    # and an all-bf16 carry compounds rounding noise across the ODE's 8
    # U-Net evals (measured on-chip: mel MCD vs the fp32 oracle more than
    # halves with fp32 carry — tests/test_tpu_e2e.py).  No-op under fp32
    # compute, so the CPU parity/golden suites are unaffected.
    fp32_residual: bool = True

    @property
    def num_downsamples(self) -> int:
        return len(self.channels) - 1


@dataclass(frozen=True)
class CFMConfig:
    solver: str = "midpoint"    # euler | midpoint | rk4 | heun3
    sigma_min: float = 1e-4
    use_mu_prior: bool = True   # start the ODE from mu + noise, not pure noise


@dataclass(frozen=True)
class DataStatistics:
    mel_mean: float = -4.684777
    mel_std: float = 6.512275


@dataclass(frozen=True)
class MatchaConfig:
    n_spks: int = 16
    n_feats: int = 100
    spk_emb_dim: int = 96
    # "float32" or "bfloat16": activation compute dtype for the transformer/
    # U-Net bodies.  Params stay fp32; MAS, prior/duration losses, mel head,
    # final velocity projection, and the ODE state remain fp32 islands
    # (reference bf16-mixed regime: configs/trainer/default.yaml:20-26,
    # matcha_tts.py:97-106).
    compute_dtype: str = "float32"
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    duration_predictor: DurationPredictorConfig = field(
        default_factory=DurationPredictorConfig
    )
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)
    data_statistics: DataStatistics = field(default_factory=DataStatistics)
    # MAS implementation of the training path.  In the port "auto", "pallas"
    # and "pallas_shard_map" send a CUDA tensor to the hand-written MAS
    # kernel (ops/csrc/mas.cu); "scan" asks for the plain PyTorch version.
    # A tensor on the CPU always takes the plain version.
    mas_backend: str = "auto"
    # Self-attention implementation for the encoder and decoder blocks.  In
    # the port "auto" and "flash" both send a CUDA tensor to the hand-written
    # masked-attention kernel (ops/csrc/masked_attention_fwd.cu) at every
    # sequence length; "einsum" asks for the plain PyTorch version.  A tensor
    # on the CPU always takes the plain version.
    attention_backend: str = "auto"
    prior_loss: bool = True
    prior_loss_threshold: float = 0.03   # Huber delta for the prior loss
    duration_loss_threshold: float = 1.0  # Huber delta for the duration loss

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def model_class(self):
        """The module this config builds: ``models/matcha.MatchaTTS``."""
        from matcha_tpu_torch.models.matcha import MatchaTTS  # the models import this module

        return MatchaTTS

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MatchaConfig":
        d = dict(d)
        for key, sub in (
            ("encoder", EncoderConfig),
            ("duration_predictor", DurationPredictorConfig),
            ("decoder", DecoderConfig),
            ("cfm", CFMConfig),
            ("data_statistics", DataStatistics),
        ):
            if key in d and isinstance(d[key], dict):
                d[key] = sub(**d[key])
        if "decoder" in d and isinstance(d["decoder"], DecoderConfig):
            d["decoder"] = dataclasses.replace(
                d["decoder"], channels=tuple(d["decoder"].channels)
            )
        return cls(**d)


def tiny_config(n_spks: int = 4) -> MatchaConfig:
    """Small config for tests / CI: same topology, tiny widths."""
    return MatchaConfig(
        n_spks=n_spks,
        n_feats=8,
        spk_emb_dim=8,
        encoder=EncoderConfig(
            n_feats=8,
            n_channels=16,
            filter_channels=32,
            n_heads=2,
            n_layers=2,
            kernel_size=3,
            prenet_kernel_size=3,
            prenet_layers=2,
            rope_max_len=256,
        ),
        duration_predictor=DurationPredictorConfig(
            filter_channels=16, kernel_size=3, n_layers=2
        ),
        decoder=DecoderConfig(
            channels=(32, 32),
            attention_head_dim=8,
            n_blocks=1,
            num_mid_blocks=1,
            num_heads=2,
        ),
    )


DIT_ARCH = "f5tts_dit"


@dataclass(frozen=True)
class DiTConfig:
    """F5-TTS v1 Base (arXiv:2410.06885; SWivid/F5-TTS
    ``src/f5_tts/configs/F5TTS_v1_Base.yaml``): the DiT's widths.  Defaults
    are the published ones, with the port's phoneme vocabulary
    (``text/symbols.py``'s ``N_VOCAB``) in place of F5's character set.  The module defaults the yaml does not
    set (dropout, the guidance drops, the span, the position convs) are
    ``models/dit.py``'s constants."""

    arch: str = DIT_ARCH
    n_feats: int = 100          # mel_dim: the Vocos-24k mel basis
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    text_dim: int = 512
    conv_layers: int = 4        # ConvNeXt-V2 blocks of the text embedding
    n_vocab: int = 600          # text_num_embeds; the table holds one more row, the filler 0
    compute_dtype: str = "bfloat16"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def model_class(self):
        """The module this config builds: ``models/dit.F5TTS``."""
        from matcha_tpu_torch.models.dit import F5TTS  # the models import this module

        return F5TTS

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DiTConfig":
        d = dict(d)
        if d.get("arch", DIT_ARCH) != DIT_ARCH:
            raise ValueError(f"not a DiT config: arch {d['arch']!r}")
        return cls(**d)


COSY_ARCH = "cosyvoice2_flow"


@dataclass(frozen=True)
class CosyFlowConfig:
    """CosyVoice 2's flow-matching stage (arXiv:2412.10117; FunAudioLLM/
    CosyVoice ``examples/libritts/cosyvoice2/conf/cosyvoice2.yaml``, its
    ``flow:`` block, ``CausalMaskedDiffWithXvec``): speech tokens at 25 Hz →
    80-band mels at 50 Hz, conditioned on an x-vector and a mel prompt.
    Defaults are the published widths.  ``n_xvectors`` rows of a fixed,
    seeded x-vector table stand in for CAM++ embeddings
    (``models/cosyflow.py``)."""

    arch: str = COSY_ARCH
    n_feats: int = 80              # output_size: 80 mel bands
    vocab_size: int = 6561         # speech tokens
    token_mel_ratio: int = 2       # 25 Hz tokens → 50 Hz frames
    spk_embed_dim: int = 192       # the x-vector
    n_xvectors: int = 16           # rows of the stand-in x-vector table
    # encoder (UpsampleConformerEncoder)
    encoder_dim: int = 512         # input_size and output_size
    encoder_heads: int = 8
    encoder_ffn: int = 2048        # linear_units
    encoder_layers: int = 6        # num_blocks, before the upsampling
    up_layers: int = 4             # after it
    encoder_dropout: float = 0.1   # dropout, positional and attention dropout
    pre_lookahead: int = 3         # tokens of right context
    chunk: int = 25                # static_chunk_size (tokens); ×token_mel_ratio after the upsampling
    # estimator (CausalConditionalDecoder)
    estimator_channels: tuple[int, ...] = (256,)
    estimator_blocks: int = 4      # n_blocks
    estimator_mid: int = 12        # num_mid_blocks
    estimator_heads: int = 8
    estimator_head_dim: int = 64
    estimator_dropout: float = 0.0
    # CFM (CausalConditionalCFM); flow.py's own draws are models/cosyflow.py's constants
    sigma_min: float = 1e-6
    cfg_rate: float = 0.2          # training_cfg_rate: rows with μ, x-vector and prompt zeroed
    compute_dtype: str = "bfloat16"

    @property
    def estimator_chunk(self) -> int:
        """The chunk (frames) after the upsampling and in the estimator."""
        return self.chunk * self.token_mel_ratio

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def model_class(self):
        """The module this config builds: ``models/cosyflow.CosyFlow``."""
        from matcha_tpu_torch.models.cosyflow import CosyFlow  # the models import this module

        return CosyFlow

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CosyFlowConfig":
        d = dict(d)
        if d.get("arch", COSY_ARCH) != COSY_ARCH:
            raise ValueError(f"not a CosyVoice 2 flow config: arch {d['arch']!r}")
        if "estimator_channels" in d:
            d["estimator_channels"] = tuple(d["estimator_channels"])
        return cls(**d)


MODEL_CONFIGS = {DIT_ARCH: DiTConfig, COSY_ARCH: CosyFlowConfig}


def model_config_from_dict(d: dict[str, Any]) -> "MatchaConfig | DiTConfig | CosyFlowConfig":
    """A ``config.json`` of any model: the DiT's and the flow stage's name their ``arch``."""
    return MODEL_CONFIGS.get(d.get("arch"), MatchaConfig).from_dict(d)


def tiny_dit_config() -> DiTConfig:
    """The DiT at tiny widths, fp32, for tests / CI: same topology."""
    return DiTConfig(n_feats=8, dim=64, depth=2, heads=4, dim_head=16, text_dim=32, conv_layers=2,
                     compute_dtype="float32")


def tiny_cosy_config() -> CosyFlowConfig:
    """The flow stage at tiny widths, fp32, for tests / CI: same topology,
    chunks of 4 tokens (8 frames)."""
    return CosyFlowConfig(n_feats=8, vocab_size=50, spk_embed_dim=12, n_xvectors=4, encoder_dim=32,
                          encoder_heads=4, encoder_ffn=64, encoder_layers=2, up_layers=2, chunk=4,
                          estimator_channels=(32,), estimator_blocks=1, estimator_mid=2, estimator_heads=2,
                          estimator_head_dim=16, compute_dtype="float32")
