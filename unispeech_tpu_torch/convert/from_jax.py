"""Carry the JAX package's WavLM and HuBERT-pretraining params into the
port, and back.

The JAX model keeps flax trees (kernels (in, out), convs (k, in/g, out));
the port names its parameters in the fairseq/standalone-WavLM state-dict
layout. ``wavlm_state_dict_from_jax`` maps the former onto the latter with
the same keys and transposes as the JAX package's fairseq exporter, reading
both the scanned (``layers``, leading L axis) and the unrolled
(``layer_{i}``) layer trees. ``jax_params_from_state_dict`` is its inverse,
for writing a params ``.npz`` the JAX tools read.
``hubert_state_dict_from_jax`` adds the masked-prediction heads under the
names of the JAX package's fairseq exporter (``final_proj*``,
``label_embs_concat`` with the ILS tables stacked along the rows,
``target_glu.0``, and UniSpeech-SAT's ``spk_proj``,
``layer_norm_for_extract``, ``project_q`` and ``quantizer.*``);
``jax_params_from_hubert_state_dict`` is its inverse.
``wav2vec2_state_dict_from_jax`` carries a wav2vec 2.0 / UniSpeech model
(the backbone at the top level, ``quantizer.*``, ``project_q``,
``final_proj``, ``target_glu.0``, the CTC head ``ctc_proj`` as ``proj``);
``jax_params_from_wav2vec2_state_dict`` is its inverse.
``ctc_state_dict_from_jax`` carries a CTC fine-tune model (the backbone
under ``wavlm.``, the ``proj`` head); ``jax_params_from_ctc_state_dict``
is its inverse. ``seq2seq_state_dict_from_jax`` carries a seq2seq model
(the backbone under ``wavlm.``, ``enc_proj``, the decoder in fairseq's
layout under ``decoder.``) and ``lm_state_dict_from_jax`` a TransformerLM
(fairseq's LM layout less the ``decoder.`` prefix); each has its inverse.
``ecapa_state_dict_from_jax`` and ``diarization_state_dict_from_jax``
carry the two downstream heads, whose port modules are named after the
flax tree (conv kernels (k, in, out), attention kernels (in, heads,
head_dim) and (heads, head_dim, out), BatchNorm's ``mean`` / ``var`` in
``batch_stats``); each has its inverse.
``jax_params_of`` is the training loop's export of a trained model.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from unispeech_tpu_torch.configs import (
    EncoderConfig,
    GumbelVQConfig,
    HubertPretrainConfig,
    Wav2Vec2PretrainConfig,
)

_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "out_proj")


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)


def _conv_kernel_out(w) -> np.ndarray:
    # (k, in/g, out) <-> (out, in/g, k)
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (2, 1, 0)))


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _index_tree(tree: Mapping, i: int):
    return {k: _index_tree(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _stack_trees(trees: list):
    return {k: _stack_trees([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


def _leading_dim(tree: Mapping) -> int:
    for v in tree.values():
        return _leading_dim(v) if isinstance(v, Mapping) else np.asarray(v).shape[0]
    raise ValueError("empty layer tree")


def _norm_keys(enc: EncoderConfig, i: int):
    """(JAX module name, port key prefix) of frontend layer i's norm: the
    GroupNorm ``gn_0`` of the first layer in "default" mode, a LayerNorm
    ``ln_{i}`` in every layer in "layer_norm" mode."""
    if enc.extractor_mode == "layer_norm":
        return [(f"ln_{i}", f"feature_extractor.conv_layers.{i}.2.1")]
    if i == 0:
        return [("gn_0", "feature_extractor.conv_layers.0.2")]
    return []


def wavlm_state_dict_from_jax(params: Mapping, enc: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Port state dict (fp32 tensors) from the JAX WavLM params (nested
    numpy dicts; a pretrain wrapper's params may nest them under "wavlm")."""
    if "wavlm" in params:
        params = params["wavlm"]
    sd: Dict[str, np.ndarray] = {}
    fe = params["feature_extractor"]
    for i in range(len(enc.conv_layers)):
        layer = fe[f"conv_{i}"]
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _conv_kernel_out(layer["kernel"])
        if "bias" in layer:
            sd[f"feature_extractor.conv_layers.{i}.0.bias"] = _np(layer["bias"])
        for jax_name, key in _norm_keys(enc, i):
            sd[key + ".weight"] = _np(fe[jax_name]["scale"])
            sd[key + ".bias"] = _np(fe[jax_name]["bias"])

    sd["layer_norm.weight"] = _np(params["layer_norm"]["scale"])
    sd["layer_norm.bias"] = _np(params["layer_norm"]["bias"])
    if "post_extract_proj" in params:
        sd["post_extract_proj.weight"] = _t(params["post_extract_proj"]["kernel"])
        sd["post_extract_proj.bias"] = _np(params["post_extract_proj"]["bias"])
    sd["mask_emb"] = _np(params["mask_emb"])

    e = params["encoder"]
    # torch weight_norm(dim=2): weight_g is (1, 1, K)
    sd["encoder.pos_conv.0.weight_g"] = _np(e["pos_conv"]["g"]).reshape(1, 1, -1)
    sd["encoder.pos_conv.0.weight_v"] = _conv_kernel_out(e["pos_conv"]["v"])
    sd["encoder.pos_conv.0.bias"] = _np(e["pos_conv"]["b"])
    sd["encoder.layer_norm.weight"] = _np(e["layer_norm"]["scale"])
    sd["encoder.layer_norm.bias"] = _np(e["layer_norm"]["bias"])

    if "layers" in e:
        layers = [_index_tree(e["layers"], i) for i in range(_leading_dim(e["layers"]))]
    else:
        layers = [e[f"layer_{i}"] for i in range(enc.encoder_layers)]
    for i, layer in enumerate(layers):
        pre = f"encoder.layers.{i}."
        attn = layer["self_attn"]
        for proj in _ATTN_PROJ:
            sd[pre + f"self_attn.{proj}.weight"] = _t(attn[proj]["kernel"])
            sd[pre + f"self_attn.{proj}.bias"] = _np(attn[proj]["bias"])
        if "grep_w" in attn:
            sd[pre + "self_attn.grep_linear.weight"] = _t(attn["grep_w"])
            sd[pre + "self_attn.grep_linear.bias"] = _np(attn["grep_b"])
            sd[pre + "self_attn.grep_a"] = _np(attn["grep_a"])
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[pre + f"{ln}.weight"] = _np(layer[ln]["scale"])
            sd[pre + f"{ln}.bias"] = _np(layer[ln]["bias"])
        for fc in ("fc1", "fc2"):
            node, key = layer[fc], pre + fc
            if "linear" in node:  # the GLU feed-forward's fc1
                node, key = node["linear"], key + ".linear"
            sd[key + ".weight"] = _t(node["kernel"])
            sd[key + ".bias"] = _np(node["bias"])
    if "rel_attn_bias" in e:
        sd["encoder.layers.0.self_attn.relative_attention_bias.weight"] = _np(
            e["rel_attn_bias"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor], enc: EncoderConfig) -> dict:
    """Inverse of ``wavlm_state_dict_from_jax``: the JAX WavLM params tree
    (nested numpy dicts) in the JAX default layout, layers stacked under
    ``layers`` as ``nn.scan`` keeps them."""
    s = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    fe = {}
    for i in range(len(enc.conv_layers)):
        fe[f"conv_{i}"] = {"kernel": _conv_kernel_out(s[f"feature_extractor.conv_layers.{i}.0.weight"])}
        if f"feature_extractor.conv_layers.{i}.0.bias" in s:
            fe[f"conv_{i}"]["bias"] = s[f"feature_extractor.conv_layers.{i}.0.bias"]
        for jax_name, key in _norm_keys(enc, i):
            fe[jax_name] = {"scale": s[key + ".weight"], "bias": s[key + ".bias"]}
    params = {
        "feature_extractor": fe,
        "layer_norm": {"scale": s["layer_norm.weight"], "bias": s["layer_norm.bias"]},
        "mask_emb": s["mask_emb"],
    }
    if "post_extract_proj.weight" in s:
        params["post_extract_proj"] = {"kernel": _t(s["post_extract_proj.weight"]),
                                       "bias": s["post_extract_proj.bias"]}
    e = {
        "pos_conv": {"g": s["encoder.pos_conv.0.weight_g"].reshape(-1),
                     "v": _conv_kernel_out(s["encoder.pos_conv.0.weight_v"]),
                     "b": s["encoder.pos_conv.0.bias"]},
        "layer_norm": {"scale": s["encoder.layer_norm.weight"],
                       "bias": s["encoder.layer_norm.bias"]},
    }
    layers = []
    for i in range(enc.encoder_layers):
        pre = f"encoder.layers.{i}."
        attn = {p: {"kernel": _t(s[pre + f"self_attn.{p}.weight"]),
                    "bias": s[pre + f"self_attn.{p}.bias"]} for p in _ATTN_PROJ}
        if pre + "self_attn.grep_linear.weight" in s:
            attn["grep_w"] = _t(s[pre + "self_attn.grep_linear.weight"])
            attn["grep_b"] = s[pre + "self_attn.grep_linear.bias"]
            attn["grep_a"] = s[pre + "self_attn.grep_a"]
        layer = {"self_attn": attn}
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            layer[ln] = {"scale": s[pre + f"{ln}.weight"], "bias": s[pre + f"{ln}.bias"]}
        for fc in ("fc1", "fc2"):
            if pre + f"{fc}.linear.weight" in s:  # the GLU feed-forward's fc1
                layer[fc] = {"linear": _dense_to_jax(s, pre + f"{fc}.linear")}
            else:
                layer[fc] = _dense_to_jax(s, pre + fc)
        layers.append(layer)
    e["layers"] = _stack_trees(layers)
    table = "encoder.layers.0.self_attn.relative_attention_bias.weight"
    if table in s:
        e["rel_attn_bias"] = s[table]
    params["encoder"] = e
    return params


def _dense_from_jax(heads: Dict, key: str, node: Mapping) -> None:
    heads[key + ".weight"] = _t(node["kernel"])
    heads[key + ".bias"] = _np(node["bias"])


def _dense_to_jax(s: Mapping, key: str) -> dict:
    return {"kernel": _t(s[key + ".weight"]), "bias": s[key + ".bias"]}


def _quantizer_from_jax(heads: Dict, q: Mapping) -> None:
    """A GumbelVectorQuantizer's params under ``quantizer.``: ``vars`` and
    ``weight_proj`` (depth 1) or ``weight_proj.{0,2,...}`` (deeper)."""
    heads["quantizer.vars"] = _np(q["vars"])
    if "weight_proj" in q:
        _dense_from_jax(heads, "quantizer.weight_proj", q["weight_proj"])
        return
    i = 0
    while f"weight_proj_{i}" in q:
        _dense_from_jax(heads, f"quantizer.weight_proj.{2 * i}", q[f"weight_proj_{i}"])
        i += 1
    _dense_from_jax(heads, f"quantizer.weight_proj.{2 * i}", q["weight_proj_out"])


def _quantizer_to_jax(s: Mapping, cfg: GumbelVQConfig) -> dict:
    q = {"vars": s["quantizer.vars"]}
    depth = cfg.weight_proj_depth
    if depth > 1:
        for i in range(depth - 1):
            q[f"weight_proj_{i}"] = _dense_to_jax(s, f"quantizer.weight_proj.{2 * i}")
        q["weight_proj_out"] = _dense_to_jax(s, f"quantizer.weight_proj.{2 * (depth - 1)}")
    else:
        q["weight_proj"] = _dense_to_jax(s, "quantizer.weight_proj")
    return q


def hubert_state_dict_from_jax(params: Mapping, cfg: HubertPretrainConfig
                               ) -> Dict[str, torch.Tensor]:
    """Port state dict of a HubertPretrainModel from the JAX params (the
    backbone under "wavlm", the heads beside it)."""
    sd = wavlm_state_dict_from_jax(params["wavlm"], cfg.encoder)
    heads: Dict[str, np.ndarray] = {}
    embs = _np(params["label_embs_concat"])
    heads["label_embs_concat"] = embs.reshape(-1, embs.shape[-1])
    if "final_proj" in params:
        heads["final_proj.weight"] = _t(params["final_proj"]["kernel"])
        heads["final_proj.bias"] = _np(params["final_proj"]["bias"])
    li = 0
    while f"final_proj_{li}" in params:
        heads[f"final_proj.{li}.weight"] = _t(params[f"final_proj_{li}"]["kernel"])
        heads[f"final_proj.{li}.bias"] = _np(params[f"final_proj_{li}"]["bias"])
        li += 1
    if "target_glu" in params:
        _dense_from_jax(heads, "target_glu.0", params["target_glu"]["Dense_0"])
    for name in ("spk_proj", "project_q"):
        if name in params:
            _dense_from_jax(heads, name, params[name])
    if "layer_norm_for_extract" in params:
        heads["layer_norm_for_extract.weight"] = _np(params["layer_norm_for_extract"]["scale"])
        heads["layer_norm_for_extract.bias"] = _np(params["layer_norm_for_extract"]["bias"])
    if "quantizer" in params:
        _quantizer_from_jax(heads, params["quantizer"])
    sd.update({k: torch.tensor(v) for k, v in heads.items()})
    return sd


def jax_params_from_hubert_state_dict(sd: Mapping[str, torch.Tensor],
                                      cfg: HubertPretrainConfig) -> dict:
    """Inverse of ``hubert_state_dict_from_jax``; the backbone's layers are
    stacked under ``layers`` as ``nn.scan`` keeps them."""
    s = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    params = {"wavlm": jax_params_from_state_dict(sd, cfg.encoder)}
    n_pred = len(cfg.predict_layers) or 1
    n_tables = n_pred if (cfg.separate_label_embeds or cfg.separate_layer_targets) else 1
    embs = s["label_embs_concat"]
    params["label_embs_concat"] = (embs.reshape(n_tables, -1, embs.shape[-1])
                                   if n_tables > 1 else embs)
    if "final_proj.weight" in s:
        params["final_proj"] = {"kernel": _t(s["final_proj.weight"]),
                                "bias": s["final_proj.bias"]}
    li = 0
    while f"final_proj.{li}.weight" in s:
        params[f"final_proj_{li}"] = {"kernel": _t(s[f"final_proj.{li}.weight"]),
                                      "bias": s[f"final_proj.{li}.bias"]}
        li += 1
    if "target_glu.0.weight" in s:
        params["target_glu"] = {"Dense_0": _dense_to_jax(s, "target_glu.0")}
    for name in ("spk_proj", "project_q"):
        if name + ".weight" in s:
            params[name] = _dense_to_jax(s, name)
    if "layer_norm_for_extract.weight" in s:
        params["layer_norm_for_extract"] = {"scale": s["layer_norm_for_extract.weight"],
                                            "bias": s["layer_norm_for_extract.bias"]}
    if "quantizer.vars" in s:
        params["quantizer"] = _quantizer_to_jax(s, cfg.quantizer)
    return params


def wav2vec2_state_dict_from_jax(params: Mapping, cfg: Wav2Vec2PretrainConfig
                                 ) -> Dict[str, torch.Tensor]:
    """Port state dict of a Wav2Vec2PretrainModel from the JAX params (the
    backbone under "wavlm", the heads beside it; the CTC head ``ctc_proj``
    becomes ``proj``)."""
    sd = wavlm_state_dict_from_jax(params["wavlm"], cfg.encoder)
    heads: Dict[str, np.ndarray] = {}
    for name in ("project_q", "final_proj"):
        _dense_from_jax(heads, name, params[name])
    if "quantizer" in params:
        _quantizer_from_jax(heads, params["quantizer"])
    if "target_glu" in params:
        _dense_from_jax(heads, "target_glu.0", params["target_glu"]["Dense_0"])
    if "ctc_proj" in params:
        _dense_from_jax(heads, "proj", params["ctc_proj"])
    sd.update({k: torch.tensor(v) for k, v in heads.items()})
    return sd


def jax_params_from_wav2vec2_state_dict(sd: Mapping[str, torch.Tensor],
                                        cfg: Wav2Vec2PretrainConfig) -> dict:
    """Inverse of ``wav2vec2_state_dict_from_jax``; the backbone's layers are
    stacked under ``layers`` as ``nn.scan`` keeps them."""
    s = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    params = {"wavlm": jax_params_from_state_dict(sd, cfg.encoder),
              "project_q": _dense_to_jax(s, "project_q"),
              "final_proj": _dense_to_jax(s, "final_proj")}
    if "quantizer.vars" in s:
        params["quantizer"] = _quantizer_to_jax(s, cfg.quantizer)
    if "target_glu.0.weight" in s:
        params["target_glu"] = {"Dense_0": _dense_to_jax(s, "target_glu.0")}
    if "proj.weight" in s:
        params["ctc_proj"] = _dense_to_jax(s, "proj")
    return params


def ctc_state_dict_from_jax(params: Mapping, enc: EncoderConfig) -> Dict[str, torch.Tensor]:
    """Port state dict of a CtcFinetuneModel from the JAX params (the
    backbone under "wavlm", the ``proj`` Dense beside it)."""
    sd = {"wavlm." + k: v for k, v in wavlm_state_dict_from_jax(params["wavlm"], enc).items()}
    sd["proj.weight"] = torch.tensor(_t(params["proj"]["kernel"]))
    sd["proj.bias"] = torch.tensor(_np(params["proj"]["bias"]))
    return sd


def jax_params_from_ctc_state_dict(sd: Mapping[str, torch.Tensor], enc: EncoderConfig) -> dict:
    """Inverse of ``ctc_state_dict_from_jax``; the backbone's layers are
    stacked under ``layers`` as ``nn.scan`` keeps them."""
    backbone = {k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")}
    return {"wavlm": jax_params_from_state_dict(backbone, enc),
            "proj": {"kernel": _t(sd["proj.weight"].detach().cpu().float().numpy()),
                     "bias": sd["proj.bias"].detach().cpu().float().numpy()}}


def _ln_from_jax(sd: Dict, key: str, node: Mapping) -> None:
    sd[key + ".weight"] = _np(node["scale"])
    sd[key + ".bias"] = _np(node["bias"])


def _ln_to_jax(s: Mapping, key: str) -> dict:
    return {"scale": s[key + ".weight"], "bias": s[key + ".bias"]}


def _n_layers(params: Mapping) -> int:
    n = 0
    while f"layer_{n}" in params:
        n += 1
    return n


_DEC_LN = ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm")
_LM_LN = ("self_attn_layer_norm", "final_layer_norm")


def _embeddings_from_jax(sd: Dict, pre: str, params: Mapping) -> None:
    sd[pre + "embed_tokens.weight"] = _np(params["embed_tokens"]["embedding"])
    if "embed_positions" in params:
        sd[pre + "embed_positions.weight"] = _np(params["embed_positions"]["embedding"])
    if "layer_norm" in params:
        _ln_from_jax(sd, pre + "layer_norm", params["layer_norm"])
    if "embed_out" in params:
        sd[pre + "embed_out"] = _np(params["embed_out"])


def _embeddings_to_jax(s: Mapping, pre: str) -> dict:
    out = {"embed_tokens": {"embedding": s[pre + "embed_tokens.weight"]}}
    if pre + "embed_positions.weight" in s:
        out["embed_positions"] = {"embedding": s[pre + "embed_positions.weight"]}
    if pre + "layer_norm.weight" in s:
        out["layer_norm"] = _ln_to_jax(s, pre + "layer_norm")
    if pre + "embed_out" in s:
        out["embed_out"] = s[pre + "embed_out"]
    return out


def decoder_state_dict_from_jax(dec: Mapping) -> Dict[str, torch.Tensor]:
    """Port state dict of a seq2seq TransformerDecoder from its JAX params
    (``layer_{i}`` as ``layers.{i}``)."""
    out: Dict[str, np.ndarray] = {}
    _embeddings_from_jax(out, "", dec)
    for i in range(_n_layers(dec)):
        layer, pre = dec[f"layer_{i}"], f"layers.{i}."
        for attn in ("self_attn", "encoder_attn"):
            for proj in _ATTN_PROJ:
                _dense_from_jax(out, pre + f"{attn}.{proj}", layer[attn][proj])
        for ln in _DEC_LN:
            _ln_from_jax(out, pre + ln, layer[ln])
        for fc in ("fc1", "fc2"):
            _dense_from_jax(out, pre + fc, layer[fc])
    return {k: torch.tensor(v) for k, v in out.items()}


def seq2seq_state_dict_from_jax(params: Mapping, enc: EncoderConfig
                                ) -> Dict[str, torch.Tensor]:
    """Port state dict of a Seq2SeqModel from the JAX params (the backbone
    under "wavlm", the decoder under ``decoder.``, ``enc_proj`` when
    present)."""
    sd = {"wavlm." + k: v for k, v in wavlm_state_dict_from_jax(params["wavlm"], enc).items()}
    sd.update({"decoder." + k: v for k, v in decoder_state_dict_from_jax(params["decoder"]).items()})
    if "enc_proj" in params:
        proj: Dict[str, np.ndarray] = {}
        _dense_from_jax(proj, "enc_proj", params["enc_proj"])
        sd.update({k: torch.tensor(v) for k, v in proj.items()})
    return sd


def jax_params_from_seq2seq_state_dict(sd: Mapping[str, torch.Tensor],
                                       enc: EncoderConfig) -> dict:
    """Inverse of ``seq2seq_state_dict_from_jax``; the backbone's layers are
    stacked under ``layers`` as ``nn.scan`` keeps them."""
    s = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    backbone = {k[len("wavlm."):]: v for k, v in sd.items() if k.startswith("wavlm.")}
    dec = _embeddings_to_jax(s, "decoder.")
    i = 0
    while f"decoder.layers.{i}.fc1.weight" in s:
        pre = f"decoder.layers.{i}."
        layer = {attn: {p: _dense_to_jax(s, pre + f"{attn}.{p}") for p in _ATTN_PROJ}
                 for attn in ("self_attn", "encoder_attn")}
        layer.update({ln: _ln_to_jax(s, pre + ln) for ln in _DEC_LN})
        layer.update({fc: _dense_to_jax(s, pre + fc) for fc in ("fc1", "fc2")})
        dec[f"layer_{i}"] = layer
        i += 1
    params = {"wavlm": jax_params_from_state_dict(backbone, enc), "decoder": dec}
    if "enc_proj.weight" in s:
        params["enc_proj"] = _dense_to_jax(s, "enc_proj")
    return params


def lm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Port state dict of a TransformerLM from the JAX params (a layer's
    projections under ``layers.{i}.self_attn.``)."""
    out: Dict[str, np.ndarray] = {}
    _embeddings_from_jax(out, "", params)
    for i in range(_n_layers(params)):
        layer, pre = params[f"layer_{i}"], f"layers.{i}."
        for proj in _ATTN_PROJ:
            _dense_from_jax(out, pre + f"self_attn.{proj}", layer[proj])
        for ln in _LM_LN:
            _ln_from_jax(out, pre + ln, layer[ln])
        for fc in ("fc1", "fc2"):
            _dense_from_jax(out, pre + fc, layer[fc])
    return {k: torch.tensor(v) for k, v in out.items()}


def jax_params_from_lm_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``lm_state_dict_from_jax``."""
    s = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    params = _embeddings_to_jax(s, "")
    i = 0
    while f"layers.{i}.fc1.weight" in s:
        pre = f"layers.{i}."
        layer = {p: _dense_to_jax(s, pre + f"self_attn.{p}") for p in _ATTN_PROJ}
        layer.update({ln: _ln_to_jax(s, pre + ln) for ln in _LM_LN})
        layer.update({fc: _dense_to_jax(s, pre + fc) for fc in ("fc1", "fc2")})
        params[f"layer_{i}"] = layer
        i += 1
    return params


_FLAX_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
              "var": "running_var"}


def _head_from_jax(tree: Mapping, leaf_fn, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flat port keys of a flax head tree: module names joined by ".",
    ``kernel`` and ``scale`` as ``weight``, ``mean`` / ``var`` as the
    running averages; ``leaf_fn(prefix, name, value)`` lays out each leaf."""
    out: Dict[str, np.ndarray] = {}
    for name, node in tree.items():
        if isinstance(node, Mapping):
            out.update(_head_from_jax(node, leaf_fn, f"{prefix}{name}."))
        else:
            out[prefix + _FLAX_LEAF.get(name, name)] = leaf_fn(prefix, name, _np(node))
    return out


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _ecapa_leaf(prefix: str, name: str, v: np.ndarray) -> np.ndarray:
    if name != "kernel":
        return v
    return _conv_kernel_out(v) if v.ndim == 3 else _t(v)  # convs (k, in, out); Dense


def ecapa_state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None
                              ) -> Dict[str, torch.Tensor]:
    """Port ``EcapaTdnn`` state dict from the JAX head's ``params`` and,
    when given, its ``batch_stats``. Without them every BatchNorm gets
    flax's initial running averages (mean 0, var 1), as the JAX CLIs'
    ``--head``, which replaces only the initialised ``params``, runs."""
    sd = _head_from_jax(params, _ecapa_leaf)
    if batch_stats is not None:
        sd.update(_head_from_jax(batch_stats, _ecapa_leaf))
    else:
        for key in [k for k in sd if k.endswith("BatchNorm_0.weight")]:
            stem = key[:-len("weight")]
            sd[stem + "running_mean"] = np.zeros_like(sd[key])
            sd[stem + "running_var"] = np.ones_like(sd[key])
    return {k: torch.tensor(v) for k, v in sd.items()}


def jax_params_from_ecapa_state_dict(sd: Mapping[str, torch.Tensor]) -> Tuple[dict, dict]:
    """Inverse of ``ecapa_state_dict_from_jax``: (params, batch_stats)."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        v = t.detach().cpu().float().numpy()
        stem, leaf = key.rsplit(".", 1)
        if leaf in ("running_mean", "running_var"):
            stats[f"{stem}.{leaf[len('running_'):]}"] = v
        elif leaf == "weight" and v.ndim == 1:
            params[stem + ".scale"] = v  # a LayerNorm's or BatchNorm's scale
        elif leaf == "weight":
            params[stem + ".kernel"] = _conv_kernel_out(v) if v.ndim == 3 else _t(v)
        else:
            params[key] = v
    return _nest(params), _nest(stats)


_MHA_IN = ("query", "key", "value")


def _diarization_leaf(prefix: str, name: str, v: np.ndarray) -> np.ndarray:
    proj = prefix.rstrip(".").rsplit(".", 1)[-1]
    if "MultiHeadDotProductAttention" in prefix:
        if name == "kernel" and proj in _MHA_IN:
            return _t(v.reshape(v.shape[0], -1))  # (in, heads, hd) -> (heads*hd, in)
        if name == "kernel":
            return _t(v.reshape(-1, v.shape[-1]))  # (heads, hd, out) -> (out, heads*hd)
        return v.reshape(-1)
    return _t(v) if name == "kernel" else v


def diarization_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Port ``TransformerDiarization`` state dict from the JAX head's
    params: Dense kernels transposed, the attention's per-head kernels and
    biases flattened over (heads, head_dim)."""
    return {k: torch.tensor(v) for k, v in _head_from_jax(params, _diarization_leaf).items()}


def jax_params_from_diarization_state_dict(sd: Mapping[str, torch.Tensor],
                                           num_heads: int) -> dict:
    """Inverse of ``diarization_state_dict_from_jax``."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in sd.items():
        v = t.detach().cpu().float().numpy()
        stem, leaf = key.rsplit(".", 1)
        proj = stem.rsplit(".", 1)[-1]
        if "MultiHeadDotProductAttention" in stem:
            if leaf == "weight" and proj in _MHA_IN:
                flat[stem + ".kernel"] = _t(v).reshape(v.shape[1], num_heads, -1)
            elif leaf == "weight":
                flat[stem + ".kernel"] = _t(v).reshape(num_heads, -1, v.shape[0])
            elif proj in _MHA_IN:
                flat[key] = v.reshape(num_heads, -1)
            else:
                flat[key] = v
        elif leaf == "weight":
            flat[stem + (".scale" if v.ndim == 1 else ".kernel")] = v if v.ndim == 1 else _t(v)
        else:
            flat[key] = v
    return _nest(flat)


def jax_params_of(model: torch.nn.Module) -> dict:
    """The JAX params tree of a trained port model: a HubertPretrainModel
    or a Wav2Vec2PretrainModel (the backbone under "wavlm", the heads
    beside it), a CtcFinetuneModel (the backbone under "wavlm", ``proj``),
    a Seq2SeqModel, a TransformerLM, or a downstream head (an EcapaTdnn's
    ``params``, its running averages left out, as ``--head`` reads it; a
    TransformerDiarization)."""
    from unispeech_tpu_torch.downstream.diarization import TransformerDiarization
    from unispeech_tpu_torch.downstream.ecapa_tdnn import EcapaTdnn
    from unispeech_tpu_torch.models.ctc import CtcFinetuneModel
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.models.lm import TransformerLM
    from unispeech_tpu_torch.models.seq2seq import Seq2SeqModel
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
    from unispeech_tpu_torch.parallel.sharding import full_state_dict

    # a model placed on a mesh gives its tensors whole (collective)
    sd = full_state_dict(model)
    if isinstance(model, Seq2SeqModel):
        return jax_params_from_seq2seq_state_dict(sd, model.wavlm.cfg.encoder)
    if isinstance(model, TransformerLM):
        return jax_params_from_lm_state_dict(sd)
    if isinstance(model, EcapaTdnn):
        return jax_params_from_ecapa_state_dict(sd)[0]
    if isinstance(model, TransformerDiarization):
        return jax_params_from_diarization_state_dict(sd, model.cfg.num_heads)

    if isinstance(model, HubertPretrainModel):
        return jax_params_from_hubert_state_dict(sd, model.pcfg)
    if isinstance(model, Wav2Vec2PretrainModel):
        return jax_params_from_wav2vec2_state_dict(sd, model.wcfg)
    if isinstance(model, CtcFinetuneModel):
        return jax_params_from_ctc_state_dict(sd, model.wavlm.cfg.encoder)
    raise NotImplementedError(f"no params export for {type(model).__name__} yet")


def save_params_npz(path: str, params) -> None:
    """Flat ``.npz`` of a params tree, keys joined with "/" (the JAX
    package's checkpoint format)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """Inverse of ``save_params_npz``."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree
