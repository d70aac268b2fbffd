"""The port's reference-layout converters (``convert/fairseq.py``) against the
JAX package's (``convert/fairseq_import.py``, ``fairseq_export.py``,
``torch_import.py``), on the CPU.

For each of the five model families of tests/test_converters.py, JAX
initialises the model from a seed and its exporter writes the fairseq flat
dict; the port's importer takes that dict into a port model with
``strict=True``, equal to ``*_state_dict_from_jax`` of the same params, and
the port's exporter gives the JAX exporter's dict back key for key and
value for value. Transposes are exact, so every comparison is exact. The
standalone-WavLM import, with and without ``mask_emb``, is held by a
forward against the JAX WavLM on the same reference dict (fp32).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu import configs as jcfgs
from unispeech_tpu.convert import fairseq_export as fx
from unispeech_tpu.convert import fairseq_import as fi
from unispeech_tpu.convert.torch_import import wavlm_params_from_reference
from unispeech_tpu.models.ctc import CtcFinetuneConfig as JCtcConfig
from unispeech_tpu.models.ctc import CtcFinetuneModel as JCtcModel
from unispeech_tpu.models.hubert import HubertPretrainModel as JHubertModel
from unispeech_tpu.models.wav2vec2 import Wav2Vec2PretrainModel as JWav2Vec2Model
from unispeech_tpu.models.wavlm import WavLM as JWavLM
from unispeech_tpu_torch import configs
from unispeech_tpu_torch.convert import fairseq as pf
from unispeech_tpu_torch.convert.from_jax import (
    ctc_state_dict_from_jax,
    hubert_state_dict_from_jax,
    wav2vec2_state_dict_from_jax,
    wavlm_state_dict_from_jax,
)
from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel
from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
from unispeech_tpu_torch.models.wavlm import WavLM

ENC = dict(
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_layers=((32, 10, 5), (32, 3, 2)), conv_pos=16,
    conv_pos_groups=4, relative_position_embedding=True, num_buckets=32, max_distance=64,
    gru_rel_pos=True, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    encoder_layerdrop=0.0,
)
VQ_DEPTH2 = dict(num_vars=8, groups=2, vq_dim=16, weight_proj_depth=2)
# the five roundtrip configs of tests/test_converters.py:85-140
CASES = {
    "hubert_plain": ("hubert", dict(num_classes=(11,))),
    "sat_full": ("hubert", dict(
        num_classes=(11, 7), untie_final_proj=True, target_glu=True,
        utterance_contrastive_loss=True, utterance_contrastive_layer=1, num_instances=2,
        cross_sample_instances=4, quantize_targets=True, quantizer=VQ_DEPTH2)),
    "ils_separate_embeds": ("hubert", dict(num_classes=(11,), predict_layers=(1, 2),
                                           separate_label_embeds=True)),
    "wav2vec2_unispeech": ("wav2vec2", dict(
        num_negatives=4, quantizer=dict(num_vars=8, groups=2, vq_dim=16), transpose=True,
        ctc_vocab_size=13)),
    "ctc": ("ctc", dict(vocab_size=13)),
}


def _cfg(mod, cls, ctc_cls, kind, kw, enc_over=None):
    enc = mod.EncoderConfig(**{**ENC, **(enc_over or {})})
    kw = dict(kw)
    if "quantizer" in kw:
        kw["quantizer"] = mod.GumbelVQConfig(**kw["quantizer"])
    if kind == "ctc":
        return ctc_cls(encoder=enc, **kw)
    return cls(encoder=enc, **kw)


def _jax_params(kind, jcfg):
    rng = jax.random.PRNGKey(0)
    wav = jax.random.normal(rng, (2, 4000), jnp.float32)
    if kind == "hubert":
        T = jcfg.encoder.num_frames(4000)
        tgt = jax.random.randint(rng, (2, T, len(jcfg.num_classes)), 0, min(jcfg.num_classes))
        rngs = {"params": rng, "mask": rng, "gumbel": rng, "instances": rng}
        params = JHubertModel(jcfg).init(rngs, wav, tgt, mask=True, deterministic=True)
    elif kind == "wav2vec2":
        rngs = {"params": rng, "mask": rng, "gumbel": rng, "negatives": rng, "replace": rng}
        params = JWav2Vec2Model(jcfg).init(rngs, wav, mask=True, deterministic=True)
    else:
        params = JCtcModel(jcfg).init({"params": rng, "mask": rng}, wav, deterministic=True)
    return jax.tree.map(np.asarray, dict(params["params"]))


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = want[k].numpy() if isinstance(want[k], torch.Tensor) else want[k]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_fairseq_import_export_matches_jax(case):
    kind, kw = CASES[case]
    jcfg = _cfg(jcfgs, {"hubert": jcfgs.HubertPretrainConfig,
                        "wav2vec2": jcfgs.Wav2Vec2PretrainConfig}.get(kind), JCtcConfig,
                kind, kw)
    cfg = _cfg(configs, {"hubert": configs.HubertPretrainConfig,
                         "wav2vec2": configs.Wav2Vec2PretrainConfig}.get(kind),
               CtcFinetuneConfig, kind, kw)
    params = _jax_params(kind, jcfg)
    export = {"hubert": fx.hubert_to_fairseq, "wav2vec2": fx.wav2vec2_to_fairseq,
              "ctc": fx.ctc_to_fairseq}[kind](params, jcfg)

    if kind == "hubert":
        got = pf.hubert_state_dict_from_fairseq(export, cfg)
        want = hubert_state_dict_from_jax(params, cfg)
        model = HubertPretrainModel(cfg)
        back = pf.hubert_to_fairseq
    elif kind == "wav2vec2":
        got = pf.wav2vec2_state_dict_from_fairseq(export, cfg)
        want = wav2vec2_state_dict_from_jax(params, cfg)
        model = Wav2Vec2PretrainModel(cfg)
        back = pf.wav2vec2_to_fairseq
    else:
        got = pf.ctc_state_dict_from_fairseq(export, cfg.encoder)
        want = ctc_state_dict_from_jax(params, cfg.encoder)
        model = CtcFinetuneModel(cfg)
        back = pf.ctc_to_fairseq
    _assert_dicts_equal(got, want)
    model.load_state_dict(got, strict=True)
    _assert_dicts_equal(back(model.state_dict(), cfg), export)


def test_ctc_warm_start_strips_the_wrapper():
    """The reference's warm-start path: ``w2v_encoder.w2v_model.`` stripped,
    the backbone alone into a port WavLM."""
    jcfg = _cfg(jcfgs, None, JCtcConfig, "ctc", dict(vocab_size=13))
    cfg = _cfg(configs, None, CtcFinetuneConfig, "ctc", dict(vocab_size=13))
    params = _jax_params("ctc", jcfg)
    export = fx.ctc_to_fairseq(params, jcfg)
    stripped = pf.strip_w2v_prefix(export)
    assert stripped == fi.strip_w2v_prefix(export)
    assert all(not k.startswith("w2v_encoder.") for k in stripped)
    got = pf.backbone_state_dict_from_fairseq(stripped, cfg.encoder)
    _assert_dicts_equal(got, wavlm_state_dict_from_jax(params["wavlm"], cfg.encoder))
    WavLM(configs.WavLMModelConfig(encoder=cfg.encoder)).load_state_dict(got, strict=True)


def _reference_dict(enc_over, seed):
    """A standalone-WavLM reference state dict (the JAX exporter's layout,
    torch tensors as a ``.pt`` holds them) of a JAX-initialised model."""
    jenc = jcfgs.EncoderConfig(**{**ENC, **enc_over})
    jmodel = JWavLM(jcfgs.WavLMModelConfig(encoder=jenc))
    params = jmodel.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, 4000), jnp.float32))["params"]
    sd = fx.wavlm_backbone_to_reference(jax.tree.map(np.asarray, dict(params)), jenc)
    return jmodel, jenc, {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


@pytest.mark.parametrize("with_mask_emb", [True, False], ids=["mask_emb", "no_mask_emb"])
@pytest.mark.parametrize("enc_over", [{}, dict(extractor_mode="layer_norm",
                                               layer_norm_first=True, normalize=True)],
                         ids=["base_style", "large_style"])
def test_standalone_wavlm_import_matches_jax_forward(with_mask_emb, enc_over):
    """The port's forward on the imported reference dict against the JAX
    WavLM on ``wavlm_params_from_reference`` of the same dict, fp32, with
    padded rows. Without ``mask_emb`` the port keeps its own (the forward
    does not read it; JAX's params get the same value)."""
    jmodel, jenc, sd = _reference_dict(enc_over, seed=3)
    enc = configs.EncoderConfig(**{**ENC, **enc_over})
    model = WavLM(configs.WavLMModelConfig(encoder=enc),
                  generator=torch.Generator().manual_seed(1))
    own = model.mask_emb.detach().clone()
    if not with_mask_emb:
        del sd["mask_emb"]
        with pytest.raises(KeyError, match="mask_emb"):
            pf.wavlm_state_dict_from_reference(sd, enc)
    got = pf.wavlm_state_dict_from_reference(sd, enc, mask_emb=model.mask_emb)
    model.load_state_dict(got, strict=True)
    want_emb = sd["mask_emb"] if with_mask_emb else own
    assert torch.equal(model.mask_emb.detach(), want_emb)
    model.eval()

    jparams = wavlm_params_from_reference({k: v.numpy() for k, v in sd.items()},
                                          jcfgs.WavLMModelConfig(encoder=jenc))
    if not with_mask_emb:
        jparams["mask_emb"] = own.numpy()
    rng = np.random.RandomState(0)
    wav = rng.randn(3, 4000).astype(np.float32)
    lengths = np.asarray([4000, 2900, 1650], np.int32)
    want = jmodel.apply({"params": jparams}, jnp.asarray(wav), lengths=jnp.asarray(lengths),
                        mask=False).x
    with torch.no_grad():
        out = model(torch.from_numpy(wav), lengths=torch.from_numpy(lengths).long()).x
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_reference_imports_reject_bad_layouts():
    _, _, sd = _reference_dict({}, seed=0)
    enc = configs.EncoderConfig(**ENC)
    bad = dict(sd)
    bad["encoder.pos_conv.0.weight_g"] = sd["encoder.pos_conv.0.weight_g"].reshape(-1)
    with pytest.raises(ValueError, match="weight_g"):
        pf.wavlm_state_dict_from_reference(bad, enc)
    # extra keys (pretraining heads, BatchNorm counters) are left out
    extra = dict(sd, **{"final_proj.weight": torch.zeros(3, 3),
                        "label_embs_concat": torch.zeros(3, 3)})
    assert sorted(pf.wavlm_state_dict_from_reference(extra, enc)) == sorted(sd)


def test_reference_checkpoint_save_load_roundtrip(tmp_path):
    """A ``.pt`` whose ``model`` entry is the state dict and ``cfg`` the
    config: written, read back with ``weights_only=True``, taken by the
    port model with ``strict=True``, every tensor equal."""
    _, _, sd = _reference_dict({}, seed=1)
    enc = configs.EncoderConfig(**ENC)
    cfg = {"encoder_layers": 2, "conv_feature_layers": "[(32,10,5)] + [(32,3,2)]"}
    path = str(tmp_path / "WavLM-tiny.pt")
    pf.save_reference_checkpoint(path, {k: v.numpy() for k, v in sd.items()}, cfg)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert set(raw) == {"model", "cfg"}
    back, back_cfg = pf.load_reference_checkpoint(path)
    assert back_cfg == cfg and sorted(back) == sorted(sd)
    for k in sd:
        assert back[k].dtype == torch.float32 and torch.equal(back[k], sd[k]), k
    model = WavLM(configs.WavLMModelConfig(encoder=enc))
    model.load_state_dict(pf.wavlm_state_dict_from_reference(back, enc), strict=True)

    # fairseq's older checkpoints keep an argparse Namespace under "args":
    # read in full only when trusted
    torch.save({"model": sd, "args": argparse.Namespace(encoder_layers=2)},
               tmp_path / "pickled.pt")
    with pytest.raises(ValueError, match="trusted"):
        pf.load_reference_checkpoint(str(tmp_path / "pickled.pt"))
    back, args = pf.load_reference_checkpoint(str(tmp_path / "pickled.pt"), trusted=True)
    assert args.encoder_layers == 2 and sorted(back) == sorted(sd)
