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
``target_glu.0``); ``jax_params_from_hubert_state_dict`` is its inverse.
``ctc_state_dict_from_jax`` carries a CTC fine-tune model (the backbone
under ``wavlm.``, the ``proj`` head); ``jax_params_from_ctc_state_dict``
is its inverse. ``jax_params_of`` is the training loop's export of a
trained model.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from unispeech_tpu_torch.configs import EncoderConfig, HubertPretrainConfig

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
            sd[pre + f"{fc}.weight"] = _t(layer[fc]["kernel"])
            sd[pre + f"{fc}.bias"] = _np(layer[fc]["bias"])
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
            layer[fc] = {"kernel": _t(s[pre + f"{fc}.weight"]), "bias": s[pre + f"{fc}.bias"]}
        layers.append(layer)
    e["layers"] = _stack_trees(layers)
    table = "encoder.layers.0.self_attn.relative_attention_bias.weight"
    if table in s:
        e["rel_attn_bias"] = s[table]
    params["encoder"] = e
    return params


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
        dense = params["target_glu"]["Dense_0"]
        heads["target_glu.0.weight"] = _t(dense["kernel"])
        heads["target_glu.0.bias"] = _np(dense["bias"])
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
        params["target_glu"] = {"Dense_0": {"kernel": _t(s["target_glu.0.weight"]),
                                            "bias": s["target_glu.0.bias"]}}
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


def jax_params_of(model: torch.nn.Module) -> dict:
    """The JAX params tree of a trained port model: a HubertPretrainModel
    (the backbone under "wavlm", the heads beside it) or a
    CtcFinetuneModel (the backbone under "wavlm", ``proj``)."""
    from unispeech_tpu_torch.models.ctc import CtcFinetuneModel
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel

    if isinstance(model, HubertPretrainModel):
        return jax_params_from_hubert_state_dict(model.state_dict(), model.pcfg)
    if isinstance(model, CtcFinetuneModel):
        return jax_params_from_ctc_state_dict(model.state_dict(), model.wavlm.cfg.encoder)
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
