"""The PyTorch port's WavLM feature extraction against the JAX WavLM (CPU).

The JAX model is initialised from a seed in fp32, its params are carried
into the port with ``wavlm_state_dict_from_jax`` and loaded with
``strict=True``, and the same numpy waveforms go through both. On the CPU the
JAX package runs the unfused frontend (its fusion is TPU-only) while the port
always takes the fused structure (L1 + stats, GroupNorm folded into the next
block as an affine, fused conv blocks) with the ops' plain versions, so this
also holds the fusion algebra to the unfused math. Tolerance rtol 2e-4 /
atol 2e-5, the fp32 feature tolerance the repo's converter tests use.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import WavLMModelConfig as JaxWavLMConfig
from unispeech_tpu.models.wavlm import WavLM as JaxWavLM
from unispeech_tpu_torch.configs import WavLMModelConfig
from unispeech_tpu_torch.convert.from_jax import (
    jax_params_from_state_dict,
    wavlm_state_dict_from_jax,
)
from unispeech_tpu_torch.models.wavlm import WavLM

RTOL, ATOL = 2e-4, 2e-5


def small_cfg_dict(**over):
    d = dict(
        encoder_layers=3,
        encoder_embed_dim=96,
        encoder_ffn_embed_dim=192,
        encoder_attention_heads=4,
        conv_feature_layers="[(64,10,5)] + [(64,3,2)] * 2 + [(64,2,2)]",
        conv_pos=16,
        conv_pos_groups=4,
        dropout=0.0,
        attention_dropout=0.0,
        activation_dropout=0.0,
        encoder_layerdrop=0.0,
        relative_position_embedding=True,
        num_buckets=32,
        max_distance=64,
        gru_rel_pos=True,
    )
    d.update(over)
    return d


def to_numpy_tree(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(cfg_dict, scanned=True, seed=0):
    jcfg = JaxWavLMConfig.from_reference_dict(cfg_dict)
    jcfg = dataclasses.replace(
        jcfg, encoder=dataclasses.replace(jcfg.encoder, scan_layers=scanned))
    jmodel = JaxWavLM(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, 4000), jnp.float32))["params"]
    params = to_numpy_tree(params)
    cfg = WavLMModelConfig.from_reference_dict(cfg_dict)
    model = WavLM(cfg)
    model.load_state_dict(wavlm_state_dict_from_jax(params, cfg.encoder), strict=True)
    model.eval()
    return jmodel, params, model


def jax_extract(jmodel, params, wav, lengths, **kw):
    fn = jax.jit(lambda p, w, n: jmodel.apply(
        {"params": p}, w, lengths=n, method=JaxWavLM.extract_features, **kw))
    return fn(params, jnp.asarray(wav), jnp.asarray(lengths))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


CONFIGS = {
    "base_style": {},
    "no_relpos": {"relative_position_embedding": False, "gru_rel_pos": False},
}


@pytest.mark.parametrize("scanned", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_extract_features_match_jax(name, scanned):
    jmodel, params, model = build_pair(small_cfg_dict(**CONFIGS[name]), scanned)
    rng = np.random.RandomState(0)
    wav = rng.randn(3, 4000).astype(np.float32)
    lengths = np.asarray([4000, 2900, 1650], np.int32)

    jout = jax_extract(jmodel, params, wav, lengths, collect_layer_outputs=True)
    out = model.extract_features(torch.from_numpy(wav), lengths=torch.from_numpy(lengths),
                                 collect_layer_outputs=True)
    assert out.x.shape == jout.x.shape
    close(out.conv_features, jout.conv_features)
    close(out.x, jout.x)
    close(out.layer_outputs, jout.layer_outputs)
    np.testing.assert_array_equal(out.padding_mask.numpy(), np.asarray(jout.padding_mask))

    jmid = jax_extract(jmodel, params, wav, lengths, output_layer=2)
    mid = model.extract_features(torch.from_numpy(wav), lengths=torch.from_numpy(lengths),
                                 output_layer=2)
    close(mid.x, jmid.x)


VARIANTS = {
    # unfused frontend: plain convs, GroupNorm, GELU; conv bias carried
    "unfused_conv_bias": {"use_fused_conv": False, "conv_bias": True},
    # plain first conv, its GroupNorm folded into the fused blocks from x
    "plain_l1": {"use_fused_l1": False},
    # attention through the materialized reference path
    "materialized_attention": {"use_flash_attention": False},
    "pre_ln_normalize": {"layer_norm_first": True, "normalize": True},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variants_match_jax(name):
    jmodel, params, model = build_pair(small_cfg_dict(**VARIANTS[name]))
    wav = np.random.RandomState(1).randn(2, 4000).astype(np.float32)
    lengths = np.asarray([4000, 3100], np.int32)
    jout = jax_extract(jmodel, params, wav, lengths)
    out = model.extract_features(torch.from_numpy(wav), lengths=torch.from_numpy(lengths))
    close(out.x, jout.x)


def test_attn_mask_matches_jax():
    """A (T, S) additive streaming mask reaches every layer's attention."""
    jmodel, params, model = build_pair(small_cfg_dict())
    wav = np.random.RandomState(2).randn(2, 4000).astype(np.float32)
    T = 99  # frames of 4000 samples under the small conv spec
    idx = np.arange(T)
    amask = np.where(idx[None, :] > idx[:, None] + 8, -1e4, 0.0).astype(np.float32)
    jout = jax.jit(lambda p, w, m: jmodel.apply({"params": p}, w, attn_mask=m))(
        params, jnp.asarray(wav), jnp.asarray(amask))
    out = model(torch.from_numpy(wav), attn_mask=torch.from_numpy(amask))
    close(out.x.detach(), jout.x)


def test_params_round_trip():
    """The inverse carry gives back the (scanned) JAX tree it came from."""
    cfg_dict = small_cfg_dict()
    _, params, model = build_pair(cfg_dict)
    enc = WavLMModelConfig.from_reference_dict(cfg_dict).encoder
    back = jax_params_from_state_dict(model.state_dict(), enc)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_not_in_slice_raises():
    """The GLU feed-forward is still not ported. Masking and dropout are:
    they draw from an explicit generator and refuse to run without one."""
    cfg = WavLMModelConfig.from_reference_dict(small_cfg_dict(activation_fn="glu"))
    with pytest.raises(NotImplementedError):
        WavLM(cfg)
    model = WavLM(WavLMModelConfig.from_reference_dict(small_cfg_dict()))
    wav = torch.zeros(1, 4000)
    with pytest.raises(ValueError):
        model(wav, mask=True)
    with pytest.raises(ValueError):
        model(wav, deterministic=False)
    out = model(wav, mask=True, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert out.mask_indices.shape == (1, 99) and torch.isfinite(out.x).all()


@pytest.mark.parametrize("boundary", [False, True], ids=["span_sampler", "boundary_mask"])
def test_masked_forward_matches_jax(boundary):
    """mask=True with the mask JAX drew (fed to the port as its precomputed
    mask), or JAX's boundary_mask path: the masked forward, the mask indices
    (never on padding) and the feature penalty over the valid frames agree."""
    jmodel, params, model = build_pair(small_cfg_dict(dropout_input=0.0))
    rng = np.random.RandomState(4)
    wav = rng.randn(3, 4000).astype(np.float32)
    lengths = np.asarray([4000, 2900, 1650], np.int32)
    kw = dict(lengths=jnp.asarray(lengths), mask=True)
    if boundary:
        kw["boundary_mask"] = jnp.asarray(rng.rand(3, 99) < 0.5)
    jout = jax.jit(lambda p, w: jmodel.apply({"params": p}, w, rngs={"mask": jax.random.PRNGKey(3)},
                                             **kw))(params, jnp.asarray(wav))
    mask = np.array(jout.mask_indices)
    out = model(torch.from_numpy(wav), lengths=torch.from_numpy(lengths), mask=True,
                boundary_mask=torch.from_numpy(np.array(kw["boundary_mask"]) if boundary
                                               else mask))
    np.testing.assert_array_equal(out.mask_indices.numpy(), mask)
    assert not (mask & np.asarray(jout.padding_mask)).any()
    close(out.x.detach(), jout.x)
    np.testing.assert_allclose(float(out.features_pen.detach()), float(jout.features_pen), rtol=1e-5)


def test_training_forward_draws_from_the_generator():
    """deterministic=False: dropout and layerdrop run, the same generator
    seed gives the same output, another seed another one."""
    cfg = WavLMModelConfig.from_reference_dict(small_cfg_dict(
        dropout=0.1, attention_dropout=0.1, activation_dropout=0.1, encoder_layerdrop=0.2,
        dropout_input=0.1))
    model = WavLM(cfg, generator=torch.Generator().manual_seed(0))
    wav = torch.from_numpy(np.random.RandomState(5).randn(2, 4000).astype(np.float32))
    run = lambda seed: model(wav, deterministic=False,
                             generator=torch.Generator().manual_seed(seed)).x
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    assert not torch.allclose(a, model(wav).x)


def test_quant_noise_raises_in_training_only():
    """iPQ quantization noise is not ported: an encoder that trains with
    quant_noise_pq > 0 raises instead of training without the noise. Serving
    is exact (the noise acts in training only): the same weights give the
    same features as without the field."""
    wav = torch.from_numpy(np.random.RandomState(6).randn(2, 4000).astype(np.float32))
    plain = WavLM(WavLMModelConfig.from_reference_dict(small_cfg_dict()),
                  generator=torch.Generator().manual_seed(0))
    noisy = WavLM(WavLMModelConfig.from_reference_dict(small_cfg_dict(quant_noise_pq=0.1)))
    noisy.load_state_dict(plain.state_dict(), strict=True)
    with pytest.raises(NotImplementedError, match="quant_noise_pq"):
        noisy(wav, deterministic=False, generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="quant_noise_pq"):
        noisy(wav, mask=True, deterministic=False, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(noisy.extract_features(wav).x, plain.extract_features(wav).x,
                               rtol=0, atol=0)


# WavLM-Large's frontend ("layer_norm" extractor: conv, fp32 LayerNorm, GELU
# in every layer) at small widths. On the CPU the JAX package runs it
# unfused; the port takes its fused structure (the L1 op without the sums,
# norm-free conv blocks with the post-LN GELU deferred into the next block's
# input pass) unless the config turns fusion off.
LN_CONV = "[(48,10,5)] + [(48,3,2)] * 2 + [(48,2,2)]"
LN_VARIANTS = {"fused": {}, "plain_l1": {"use_fused_l1": False},
               "unfused": {"use_fused_conv": False}}


def _randomize_norms(params, seed=7):
    """Non-trivial LayerNorm scales and biases (init gives ones and zeros),
    so the carried keys are tested."""
    rng = np.random.RandomState(seed)
    fe = params["feature_extractor"] if "feature_extractor" in params else params
    for name in [n for n in fe if n.startswith("ln_")]:
        dim = fe[name]["scale"].shape
        fe[name] = {"scale": (1.0 + 0.2 * rng.randn(*dim)).astype(np.float32),
                    "bias": (0.1 * rng.randn(*dim)).astype(np.float32)}
    return params


def _extractor_pair(over, seed=0):
    """The JAX ConvFeatureExtractor (fp32) and the port's, with the JAX
    params carried over by the converter's key layout."""
    from unispeech_tpu.models.encoder import ConvFeatureExtractor as JaxExtractor
    from unispeech_tpu_torch.models.encoder import ConvFeatureExtractor

    jenc = JaxWavLMConfig.from_reference_dict(
        small_cfg_dict(extractor_mode="layer_norm", conv_feature_layers=LN_CONV, **over)).encoder
    jext = JaxExtractor(jenc)
    params = to_numpy_tree(jext.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4000)))["params"])
    params = _randomize_norms(params)
    enc = WavLMModelConfig.from_reference_dict(
        small_cfg_dict(extractor_mode="layer_norm", conv_feature_layers=LN_CONV, **over)).encoder
    ext = ConvFeatureExtractor(enc, torch.float32)
    sd = {}  # the converter's frontend keys, without the "feature_extractor." prefix
    for i in range(len(enc.conv_layers)):
        sd[f"conv_layers.{i}.0.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(params[f"conv_{i}"]["kernel"], (2, 1, 0))))
        sd[f"conv_layers.{i}.2.1.weight"] = torch.from_numpy(params[f"ln_{i}"]["scale"])
        sd[f"conv_layers.{i}.2.1.bias"] = torch.from_numpy(params[f"ln_{i}"]["bias"])
    ext.load_state_dict(sd, strict=True)
    return jext, params, ext


@pytest.mark.parametrize("name", list(LN_VARIANTS))
def test_layer_norm_extractor_matches_jax(name):
    """The layer_norm frontend alone, fp32, against the JAX module: rtol
    2e-4 / atol 2e-5 (the same products summed in other orders)."""
    jext, params, ext = _extractor_pair(LN_VARIANTS[name])
    wav = np.random.RandomState(8).randn(3, 4001).astype(np.float32)
    want = jext.apply({"params": params}, jnp.asarray(wav))
    got = ext(torch.from_numpy(wav))
    assert got.shape == want.shape
    close(got.detach(), want)


def test_layer_norm_extractor_grads_match_jax():
    """Gradients of every frontend weight (the L1 kernel through the no-sums
    op's backward, the conv blocks, the LayerNorms) against jax.grad of the
    JAX module, fp32: rtol 1e-4 / atol 1e-4 of each gradient's scale (sums
    over time in other orders)."""
    jext, params, ext = _extractor_pair({})
    rng = np.random.RandomState(9)
    wav = rng.randn(2, 4001).astype(np.float32)
    want_out = jext.apply({"params": params}, jnp.asarray(wav))
    cot = rng.randn(*want_out.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jext.apply({"params": p}, jnp.asarray(wav)) * cot))(
        params)
    (ext(torch.from_numpy(wav)) * torch.from_numpy(cot)).sum().backward()
    for i in range(len(ext.conv_layers)):
        pairs = [(ext.conv_layers[i].conv.weight.grad.permute(2, 1, 0),
                  jgrads[f"conv_{i}"]["kernel"]),
                 (ext.conv_layers[i].norm._modules["1"].weight.grad, jgrads[f"ln_{i}"]["scale"]),
                 (ext.conv_layers[i].norm._modules["1"].bias.grad, jgrads[f"ln_{i}"]["bias"])]
        for got, want in pairs:
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


LARGE_STYLE = dict(extractor_mode="layer_norm", layer_norm_first=True, normalize=True,
                   encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                   encoder_attention_heads=4, conv_feature_layers=LN_CONV)


def test_large_style_extract_features_match_jax():
    """A tiny WavLM-Large-style model (layer_norm extractor, pre-LN,
    normalized input, a projection from 48 conv channels to width 64) with
    padded utterances: conv features, every layer's input and the output
    against JAX extract_features, params carried by from_jax."""
    jmodel, params, model = build_pair(small_cfg_dict(**LARGE_STYLE))
    params = _randomize_norms(params)
    enc = WavLMModelConfig.from_reference_dict(small_cfg_dict(**LARGE_STYLE)).encoder
    model.load_state_dict(wavlm_state_dict_from_jax(params, enc), strict=True)
    rng = np.random.RandomState(10)
    wav = rng.randn(3, 4000).astype(np.float32)
    lengths = np.asarray([4000, 2900, 1650], np.int32)
    jout = jax_extract(jmodel, params, wav, lengths, collect_layer_outputs=True)
    out = model.extract_features(torch.from_numpy(wav), lengths=torch.from_numpy(lengths),
                                 collect_layer_outputs=True)
    assert out.x.shape == jout.x.shape == (3, 99, 64)
    close(out.conv_features, jout.conv_features)
    close(out.layer_outputs, jout.layer_outputs)
    close(out.x, jout.x)
    jmid = jax_extract(jmodel, params, wav, lengths, output_layer=1)
    close(model.extract_features(torch.from_numpy(wav), lengths=torch.from_numpy(lengths),
                                 output_layer=1).x, jmid.x)


def test_layer_norm_params_round_trip():
    """The ln_{i} keys: JAX params load into the port strictly (every
    feature_extractor.conv_layers.{i}.2.1.* key present, no gn_0), and the
    inverse carry gives back the JAX tree."""
    cfg_dict = small_cfg_dict(**LARGE_STYLE)
    _, params, model = build_pair(cfg_dict)
    enc = WavLMModelConfig.from_reference_dict(cfg_dict).encoder
    params = _randomize_norms(params)
    model.load_state_dict(wavlm_state_dict_from_jax(params, enc), strict=True)
    norm_keys = [k for k in model.state_dict()
                 if k.startswith("feature_extractor.") and k.split(".")[3] == "2"]
    assert sorted(norm_keys) == sorted(
        f"feature_extractor.conv_layers.{i}.2.1.{p}" for i in range(4)
        for p in ("weight", "bias"))
    back = jax_params_from_state_dict(model.state_dict(), enc)
    assert "gn_0" not in back["feature_extractor"]
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
