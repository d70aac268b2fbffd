"""The port's UniSpeech-SAT speaker-contrastive branch against the JAX
package's (CPU, fp32).

A tiny HubertPretrainModel with ``utterance_contrastive_loss`` is
initialised by JAX, carried into the port with
``hubert_state_dict_from_jax`` and loaded with ``strict=True``. Dropout and
layerdrop are 0; the port gets JAX's mask as ``boundary_mask``. The JAX
instance sampler is pure: the test records the keys it is called with
(monkeypatch on the JAX module's ``sample_instance_indices``), draws the
uniforms those keys give and feeds them to the port's
``instance_uniforms``; the quantizer's Gumbel noise is recorded and fed as
in tests/test_torch_quantizer.py.

With the quantizer the batch has no padded frame (the port keeps padded
frames out of the quantizer's perplexities; tests/test_torch_quantizer.py
holds that against JAX on the valid frames alone); without it the rows are
padded.

Tolerances, fp32: logits, metrics and losses rtol 1e-5; indices, targets
and masks equal; per-parameter gradients relative L2 1e-5 plus 1e-6 of the
global norm (the k_proj bias's gradient is zero analytically).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unispeech_tpu.models.hubert as jhubert
from tests.test_torch_quantizer import JaxDraws, feed
from unispeech_tpu.configs import EncoderConfig as JEncoderConfig
from unispeech_tpu.configs import GumbelVQConfig as JGumbelVQConfig
from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
from unispeech_tpu.configs import MaskConfig as JMaskConfig
from unispeech_tpu.train.losses import HubertCriterionConfig as JCrit
from unispeech_tpu.train.losses import hubert_loss as jax_hubert_loss
from unispeech_tpu_torch.configs import EncoderConfig, GumbelVQConfig, HubertPretrainConfig
from unispeech_tpu_torch.configs import MaskConfig
from unispeech_tpu_torch.convert.from_jax import (
    hubert_state_dict_from_jax,
    jax_params_from_hubert_state_dict,
)
from unispeech_tpu_torch.models import hubert
from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.ops import quantizer
from unispeech_tpu_torch.train.losses import HubertCriterionConfig, hubert_loss

ENC = dict(
    conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0,
)
SAT = dict(num_classes=(13,), final_dim=24, utterance_contrastive_loss=True,
           utterance_contrastive_layer=1, num_instances=2, cross_sample_instances=5)
VQ = dict(num_vars=8, groups=2, vq_dim=24)
B, NS = 3, 3000
LENGTHS = np.asarray([3000, 2400, 1700], np.int32)
FULL = np.full(B, NS, np.int32)  # no padded frame
VARIANTS = {
    "plain": dict(),
    "quantized": dict(quantize_targets=True),
    "large_style_glu": dict(quantize_targets=True, target_glu=True, predict_layers=(1, 2),
                            enc=dict(extractor_mode="layer_norm", layer_norm_first=True,
                                     normalize=True)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under a
    parallel test run OpenMP's spinning threads slow them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_pair(variant):
    v = dict(VARIANTS[variant])
    e = {**ENC, **v.pop("enc", {})}
    mask = dict(mask_prob=0.65, mask_length=4)
    jcfg = JHubertConfig(encoder=JEncoderConfig(**e), time_mask=JMaskConfig(**mask),
                         quantizer=JGumbelVQConfig(**VQ), **SAT, **v)
    cfg = HubertPretrainConfig(encoder=EncoderConfig(**e), time_mask=MaskConfig(**mask),
                               quantizer=GumbelVQConfig(**VQ), **SAT, **v)
    jmodel = jhubert.HubertPretrainModel(jcfg)
    T = cfg.encoder.num_frames(NS)
    params = jmodel.init({k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params", "mask", "instances", "gumbel"))}, jnp.zeros((1, NS)),
        jnp.zeros((1, T, 1), jnp.int32), mask=True, deterministic=True)["params"]
    params = jax.tree.map(np.array, params)
    model = HubertPretrainModel(cfg)
    model.load_state_dict(hubert_state_dict_from_jax(params, cfg), strict=True)
    return jmodel, params, cfg, model


def batch(T, seed=0, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return {"source": rng.randn(B, NS).astype(np.float32),
            "targets": rng.randint(0, 13, (B, T, 1)).astype(np.int32), "lengths": lengths}


class InstanceKeys:
    """Records the keys and output of the JAX module's instance sampler."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = jhubert.sample_instance_indices

        def wrap(r_same, r_cross, lengths, T, n_same, n_cross):
            out = real(r_same, r_cross, lengths, T, n_same, n_cross)
            self.calls.append((r_same, r_cross, T, n_same, n_cross, np.asarray(out)))
            return out

        monkeypatch.setattr(jhubert, "sample_instance_indices", wrap)

    def uniforms(self):
        (r_same, r_cross, T, n_same, n_cross, idx), = self.calls
        return (np.asarray(jax.random.uniform(r_same, (B, T, n_same))),
                np.asarray(jax.random.uniform(r_cross, (B, T, n_cross))), idx)


@pytest.mark.parametrize("lengths", [[50, 31, 7], [50, 0, 50], [1, 2, 3]],
                         ids=["ragged", "zero_row", "short"])
def test_instance_indices_equal_jax(lengths):
    """The port's rank arithmetic on JAX's uniforms gives JAX's indices."""
    T = 50
    lens = jnp.asarray(lengths, jnp.int32)
    for seed in range(3):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        want = np.asarray(jhubert.sample_instance_indices(k1, k2, lens, T, 3, 9))
        u1 = torch.from_numpy(np.array(jax.random.uniform(k1, (3, T, 3))))
        u2 = torch.from_numpy(np.array(jax.random.uniform(k2, (3, T, 9))))
        got = hubert.sample_instance_indices(u1, u2, torch.tensor(lengths), T)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sat_forward_loss_and_gradients_match_jax(monkeypatch, variant):
    """The speaker logits and targets, the prediction logits, the loss with
    its spk BCE (and prob-perplexity, with the quantizer) terms and their
    metrics, and the gradients, with JAX's draws."""
    jmodel, params, cfg, model = build_pair(variant)
    T = cfg.encoder.num_frames(NS)
    # with the quantizer no padded frame: the port keeps padded frames out of
    # its perplexities, the JAX package does not (ops/quantizer.py)
    b = batch(T, lengths=FULL if cfg.quantize_targets else LENGTHS)
    keys = InstanceKeys(monkeypatch)
    draws = JaxDraws(monkeypatch, "gumbel")
    jcrit = JCrit(spk_loss_weight=0.5, prob_ppl_weight=0.1)
    rngs = {k: jax.random.PRNGKey(i + 20) for i, k in enumerate(
        ("mask", "instances", "gumbel", "dropout"))}

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(b["source"]), jnp.asarray(b["targets"]),
                           jnp.asarray(b["lengths"]), mask=True, deterministic=False,
                           num_updates=5, rngs=rngs)
        loss, _, met = jax_hubert_loss(out, jcrit)
        return loss, (out, met)

    (jl, (jout, jmet)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    u_same, u_cross, jidx = keys.uniforms()
    feed(monkeypatch, hubert, "instance_uniforms", (u_same, u_cross))
    if cfg.quantize_targets:
        feed(monkeypatch, quantizer, "gumbel_noise", draws.one("gumbel", (B * T * 2, 8)))
    seen = {}
    real = hubert.sample_instance_indices

    def spy(*a):
        seen["idx"] = real(*a)
        return seen["idx"]

    monkeypatch.setattr(hubert, "sample_instance_indices", spy)
    out = model(*(torch.from_numpy(b[k]) for k in ("source", "targets", "lengths")), mask=True,
                deterministic=False, generator=torch.Generator(), num_updates=5,
                boundary_mask=torch.from_numpy(np.array(jout.mask_indices)))
    loss, _, met = hubert_loss(out, HubertCriterionConfig(spk_loss_weight=0.5,
                                                          prob_ppl_weight=0.1))
    np.testing.assert_array_equal(seen["idx"].numpy(), jidx)
    np.testing.assert_array_equal(out.spk_targets.numpy(), np.asarray(jout.spk_targets))
    np.testing.assert_allclose(out.spk_logits.detach().numpy(), np.asarray(jout.spk_logits),
                               rtol=1e-5, atol=1e-5)
    for key in jout.logits:
        np.testing.assert_allclose(out.logits[key].detach().numpy(),
                                   np.asarray(jout.logits[key]), rtol=1e-5, atol=1e-5)
    assert ("loss_prob_perplexity" in met) == cfg.quantize_targets
    assert sorted(k for k in met if k != "layers_dropped") == sorted(jmet)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(met[k].detach()), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    want = hubert_state_dict_from_jax(jax.tree.map(np.asarray, jg), cfg)
    total = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, p in model.named_parameters():
        # a parameter no term reaches has no gradient here, zeros in JAX
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        w = want[name].numpy()
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w) + 1e-6 * total, name


def test_instances_avoid_padding_and_self_and_label_utterances():
    """The port's own draws for valid query frames: never padding, the
    same-row part never the query frame, the cross part over several rows.
    (A zero-length row's same-row draws point at its frame 0, in both
    packages; its frames carry no loss.)"""
    T = 50
    lengths = torch.tensor([50, 31, 7, 0])
    for seed in range(5):
        u1, u2 = hubert.instance_uniforms(torch.Generator().manual_seed(seed), 3, 9, (4, T))
        idx = hubert.sample_instance_indices(u1, u2, lengths, T)
        rows, offs = idx // T, idx % T
        query = torch.arange(T)[None, :] < lengths[:, None]
        assert (offs < lengths[rows])[query].all()
        same = idx[:3, :, :3]
        assert (same // T == torch.arange(3)[:, None, None]).all()
        for b in range(3):
            t = torch.arange(int(lengths[b]))
            assert not (same[b, t] % T == t[:, None]).any()
        assert len(torch.unique(rows[..., 3:])) > 1


def test_sat_loss_terms_off_and_on():
    """spk_loss_weight 0 drops the BCE term; prob_ppl_weight 0 the diversity
    term; the quantizer's metrics appear only with it."""
    _, _, cfg, model = build_pair("quantized")
    T = cfg.encoder.num_frames(NS)
    b = {k: torch.from_numpy(v) for k, v in batch(T).items()}
    out = model(b["source"], b["targets"], b["lengths"], mask=True, deterministic=False,
                generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        base, _, m0 = hubert_loss(out, HubertCriterionConfig())
        both, _, m1 = hubert_loss(out, HubertCriterionConfig(spk_loss_weight=0.5,
                                                             prob_ppl_weight=0.1))
    assert "loss_spk_m" not in m0 and "loss_prob_perplexity" not in m0
    ss = float(m1["sample_size"])
    want = (float(base) + 0.5 * float(m1["loss_spk_m"]) * ss
            + 0.1 * float(m1["loss_prob_perplexity"]) * ss)
    np.testing.assert_allclose(float(both), want, rtol=1e-5)
    assert 0.0 <= float(m1["contrastive_acc"]) <= 1.0


def test_sat_params_round_trip_and_tap_layer_checked():
    _, params, cfg, model = build_pair("large_style_glu")
    back = jax_params_from_hubert_state_dict(model.state_dict(), cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    with pytest.raises(ValueError, match="utterance_contrastive_layer"):
        HubertPretrainModel(dataclasses.replace(cfg, utterance_contrastive_layer=6))
