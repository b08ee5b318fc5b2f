"""The decoder's three switches of the port against the JAX package.

``DecoderConfig.block_type="conformer"``, ``remat=True`` and
``bf16_norm_stats=True`` at ``tiny_config()`` widths, bridged
``init_params(..., PRNGKey(0))`` weights, inputs from numpy seeds.

  * Conformer: the U-Net velocity in fp32, 1e-5 relative to its peak (fp32
    in another summation order through ~20 layers); ``compute_losses`` and
    every gradient at dropout 0 on the batch of ``tests/test_torch_losses.py``
    at that file's tolerances (losses 1e-5, gradients max|err| / max|ref|
    1e-4; the key bias's gradient, 0 in exact arithmetic, below 1e-6 on
    both sides); fused synthesis at ``tests/test_torch_inference.py``'s
    (waveform 1e-3 of its peak).
  * Remat: with dropout on, loss and every gradient equal the step without
    remat (atol 1e-6, rtol 1e-5, as ``tests/test_train_step.py`` holds the
    JAX package), the dropout generator is left where it was, and each
    block's forward really runs twice; at dropout 0 against the JAX
    package's remat gradients, at the Conformer's tolerances.
  * bf16 statistics: the bf16 U-Net velocity against the JAX package's with
    the switch on.  Both sides round to bf16 at different points (XLA on
    the CPU may keep an fp32 intermediate that torch rounds), so the
    tolerance is the one measured for the switch off, the default regime,
    on the same inputs, doubled: the switch must not make the port drift
    further from JAX than bf16 rounding already does.  The switch is not a
    no-op: the LayerNorm output with bf16 statistics differs from the fp32
    one, and the velocity moves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.decoder import ConformerBlock, DecoderTransformerBlock
from matcha_tpu_torch.models.layers import LayerNorm
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.models.matcha import init_params as torch_init_params
from matcha_tpu_torch.weights import flatten_tree, params_from_jax, params_to_jax
from test_torch_losses import fingerprint_batch, jax_t_noise


def variant(cfg, **decoder):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **decoder))


def no_dropout(cfg):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, p_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


_PARAMS = {}


def jax_params_of(cfg):
    """init_params(cfg, PRNGKey(0)); the parameters depend on the block type
    only among the switches tested here."""
    key = cfg.decoder.block_type
    if key not in _PARAMS:
        init = jax.jit(lambda k: init_params(cfg, k))
        _PARAMS[key] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return _PARAMS[key]


@pytest.fixture(scope="module")
def conformer():
    jcfg, pcfg = variant(jax_tiny_config(), block_type="conformer"), variant(tiny_config(), block_type="conformer")
    params = jax_params_of(jcfg)
    port = MatchaTTS(pcfg)
    port.load_state_dict(params_from_jax(params, pcfg))
    return jcfg, pcfg, params, port.eval()


def velocity_inputs(seed, b=3, frames=24, c=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, frames, c)).astype(np.float32)
    mu = rng.standard_normal((b, frames, c)).astype(np.float32)
    mask = (np.arange(frames)[None] < np.array([frames, 13, 2])[:, None]).astype(np.float32)
    return x, mask, mu, np.full((b,), 0.37, np.float32)


def jax_velocity(cfg, params, inputs, masked_norm):
    def run(m, *a):
        return m.decoder(*a, masked_norm=masked_norm)

    return np.asarray(JaxMatchaTTS(cfg).apply({"params": params}, *map(jnp.asarray, inputs), method=run),
                      dtype=np.float32)


def port_velocity(port, inputs, masked_norm):
    with torch.no_grad():
        out = port.decoder.estimator(*map(torch.from_numpy, inputs), masked_norm=masked_norm)
    return out.float().numpy()


# -- Conformer ------------------------------------------------------------------

def test_conformer_blocks_are_built(conformer):
    _, pcfg, _, port = conformer
    blocks = [m for m in port.modules() if isinstance(m, ConformerBlock)]
    assert len(blocks) == 5 * pcfg.decoder.n_blocks  # 2 down, 1 mid, 2 up stages
    assert not any(isinstance(m, DecoderTransformerBlock) for m in port.modules())
    dw = blocks[0].conv_dw
    assert dw.groups == dw.in_channels == 2 * 32 and dw.kernel_size == (31,) and dw.padding == (15,)
    assert flatten_tree(params_to_jax(port.state_dict(), pcfg)).keys() == flatten_tree(conformer[2]).keys()


@pytest.mark.parametrize("masked_norm", [True, False])
def test_conformer_velocity_matches_jax(conformer, masked_norm):
    jcfg, _, params, port = conformer
    inputs = velocity_inputs(1 + masked_norm)
    ref = jax_velocity(jcfg, params, inputs, masked_norm)
    np.testing.assert_allclose(port_velocity(port, inputs, masked_norm), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def jax_losses_and_grads(cfg, params, batch, t_noise):
    model = JaxMatchaTTS(cfg)

    def loss_fn(p):
        out = model.apply({"params": p}, *map(jnp.asarray, batch), jax.random.PRNGKey(0), deterministic=True,
                          cfm_t_noise=tuple(map(jnp.asarray, t_noise)), method=JaxMatchaTTS.compute_losses)
        return out["loss"], out

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jax.tree.map(np.asarray, losses), flatten_tree(jax.tree.map(np.asarray, grads))


def port_losses_and_grads(cfg, params, batch, t_noise):
    model = MatchaTTS(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    losses = model.compute_losses(*(torch.from_numpy(np.asarray(a)) for a in batch), deterministic=True,
                                  cfm_t_noise=tuple(torch.from_numpy(a) for a in t_noise))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(losses["loss"], list(model.parameters()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, model.parameters(), grads)}
    return {k: v.detach().numpy() for k, v in losses.items()}, flatten_tree(params_to_jax(grads, cfg))


def assert_losses_and_grads_match(jcfg, pcfg):
    params = jax_params_of(jcfg)
    batch = fingerprint_batch()
    t_noise = jax_t_noise(batch[2].shape)
    (jl, jg), (tl, tg) = (jax_losses_and_grads(jcfg, params, batch, t_noise),
                          port_losses_and_grads(pcfg, params, batch, t_noise))
    for key in ("loss", "diff_loss", "dur_loss", "prior_loss"):
        np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5, atol=1e-5, err_msg=key)
    assert set(tg) == set(jg)
    bad = {}
    for k, ref in jg.items():
        if k.endswith("/to_k/bias"):
            # a bias on every key adds one constant to a query's logits,
            # which the softmax removes: its gradient is 0 in exact
            # arithmetic, and both sides hold rounding noise
            assert np.abs(ref).max() < 1e-6 and np.abs(tg[k]).max() < 1e-6, k
            continue
        scale = float(np.abs(ref).max())
        err = float(np.abs(tg[k] - ref).max())
        if (err / scale if scale > 0 else err) > 1e-4:
            bad[k] = err / scale
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]
    return jg


def test_conformer_losses_and_gradients_match_jax():
    jg = assert_losses_and_grads_match(no_dropout(variant(jax_tiny_config(), block_type="conformer")),
                                       no_dropout(variant(tiny_config(), block_type="conformer")))
    assert jg["decoder/mid0_tblock0/conv_dw/kernel"].any() and jg["decoder/up1_tblock0/ff2_out/kernel"].any()


def test_conformer_fused_synthesis_matches_jax(conformer):
    from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer
    from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
    from matcha_tpu.vocoder.vocos import init_vocos_params
    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.vocoder.vocos import VocosConfig
    from matcha_tpu_torch.weights import vocos_params_from_jax

    jcfg, pcfg, params, _ = conformer
    widths = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
    buckets = dict(text_buckets=(16, 32), mel_fine_buckets=(64, 128))
    vparams = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**widths)))
    ref = JaxSynthesizer(jcfg, params, vparams, JaxVocosConfig(**widths), **buckets)
    port = MatchaSynthesizer(pcfg, params_from_jax(params, pcfg), vocos_params_from_jax(vparams, VocosConfig(**widths)),
                             VocosConfig(**widths), device="cpu", **buckets)
    ids = [int(i) for i in np.random.default_rng(2).integers(0, 600, 12)]
    r = ref.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    p = port.synthesise_ids(ids, speaker=0, n_timesteps=2, fused=True)
    assert p.wav.shape == r.wav.shape and len(p.wav) > 0
    np.testing.assert_allclose(p.wav, r.wav, atol=1e-3 * np.abs(r.wav).max())


# -- remat ----------------------------------------------------------------------

def remat_step(block_type, remat):
    """Loss, gradients and the dropout generator's end state of one
    dropout-on ``compute_losses`` backward, and each block's forward count."""
    cfg = variant(tiny_config(), block_type=block_type, remat=remat, dropout=0.3)
    model = MatchaTTS(cfg)
    model.load_state_dict(torch_init_params(cfg, torch.Generator().manual_seed(0)))
    calls = []
    for mod in model.decoder.estimator.modules():
        if isinstance(mod, (ConformerBlock, DecoderTransformerBlock)):
            mod.register_forward_pre_hook(lambda *_: calls.append(1))
    batch = [torch.from_numpy(np.asarray(a)) for a in fingerprint_batch()]
    drop = torch.Generator().manual_seed(9)
    losses = model.compute_losses(*batch, torch.Generator().manual_seed(5), dropout_generator=drop)
    end = drop.get_state()
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(losses["loss"], list(model.parameters()), allow_unused=True)))
    return losses["loss"].detach(), grads, end, len(calls)


@pytest.mark.parametrize("block_type", ["transformer", "conformer"])
def test_remat_gradients_equal_without_remat_with_dropout_on(block_type):
    loss, grads, end, calls = remat_step(block_type, remat=False)
    r_loss, r_grads, r_end, r_calls = remat_step(block_type, remat=True)
    torch.testing.assert_close(r_loss, loss, atol=1e-6, rtol=1e-5)
    for name, g in grads.items():
        if g is None:
            assert r_grads[name] is None, name
            continue
        torch.testing.assert_close(r_grads[name], g, atol=1e-6, rtol=1e-5, msg=name)
    assert torch.equal(r_end, end)  # the generator is left as without remat
    assert calls == 5 and r_calls == 2 * calls  # the backward recomputed every block


@pytest.mark.parametrize("block_type", ["transformer", "conformer"])
def test_remat_matches_jax_remat(block_type):
    assert_losses_and_grads_match(no_dropout(variant(jax_tiny_config(), block_type=block_type, remat=True)),
                                  no_dropout(variant(tiny_config(), block_type=block_type, remat=True)))


# -- bf16 norm statistics -------------------------------------------------------

def bf16_pair(bf16_norm_stats, fp32_residual=True):
    kw = dict(bf16_norm_stats=bf16_norm_stats, fp32_residual=fp32_residual)
    jcfg = dataclasses.replace(variant(jax_tiny_config(), **kw), compute_dtype="bfloat16")
    pcfg = dataclasses.replace(variant(tiny_config(), **kw), compute_dtype="bfloat16")
    params = jax_params_of(jax_tiny_config())
    port = MatchaTTS(pcfg)
    port.load_state_dict(params_from_jax(params, pcfg))
    return jcfg, params, port.eval()


@pytest.mark.parametrize("fp32_residual", [True, False])
def test_bf16_norm_stats_velocity_matches_jax(fp32_residual):
    inputs = velocity_inputs(5)
    errs = {}
    for switch in (False, True):
        jcfg, params, port = bf16_pair(switch, fp32_residual)
        ref = jax_velocity(jcfg, params, inputs, masked_norm=True)
        errs[switch] = float(np.abs(port_velocity(port, inputs, True) - ref).max() / np.abs(ref).max())
    assert errs[True] <= 2 * max(errs[False], 1e-3), errs


def test_bf16_norm_stats_is_not_a_noop():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((3.0 + rng.standard_normal((4, 7, 32))).astype(np.float32))
    f32 = LayerNorm(32, eps=1e-5, dtype=torch.bfloat16)
    low = LayerNorm(32, eps=1e-5, dtype=torch.bfloat16, f32_stats=False)
    assert not torch.equal(f32(x), low(x))
    inputs = velocity_inputs(6)
    on, off = port_velocity(bf16_pair(True)[2], inputs, True), port_velocity(bf16_pair(False)[2], inputs, True)
    assert np.abs(on - off).max() > 0
