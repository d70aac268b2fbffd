"""Reference-layout checkpoints in and out of the port.

One module for three of the JAX package's:

  * ``convert/torch_import.py`` (``wavlm_params_from_reference``):
    ``wavlm_state_dict_from_reference``, the standalone WavLM layout of the
    published ``WavLM-Base+.pt`` / ``WavLM-Large.pt``;
  * ``convert/fairseq_import.py``: ``backbone_state_dict_from_fairseq``,
    ``hubert_state_dict_from_fairseq`` (HuBERT, ILS, WavLM and
    UniSpeech-SAT pretraining), ``wav2vec2_state_dict_from_fairseq``
    (wav2vec 2.0 / UniSpeech), ``strip_w2v_prefix`` and
    ``ctc_state_dict_from_fairseq`` (fine-tune checkpoints, the backbone
    under ``w2v_encoder.w2v_model.``, the vocabulary head at
    ``w2v_encoder.proj``);
  * ``convert/fairseq_export.py``: ``hubert_to_fairseq``,
    ``wav2vec2_to_fairseq`` and ``ctc_to_fairseq``.

The port names its parameters in the reference layout already (Linear
weights (out, in), Conv1d weights (out, in/g, k), the positional conv's
``weight_g`` (1, 1, K)), so each converter here is a filter of keys and a
prefix: the importers keep the keys a port model has and give fp32 tensors
that ``load_state_dict(strict=True)`` takes; the exporters give the JAX
exporters' flat ``{name: fp32 ndarray}`` dicts, key for key.
``load_reference_checkpoint`` / ``save_reference_checkpoint`` read and
write a ``.pt`` whose ``model`` entry is such a state dict (and ``cfg`` the
model's config), the reference's checkpoint format.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from unispeech_tpu_torch.configs import EncoderConfig

W2V_PREFIX = "w2v_encoder.w2v_model."
# heads beside the backbone: prefixes of their keys in the reference layout
_HUBERT_HEADS = ("label_embs_concat", "final_proj.", "target_glu.0.", "spk_proj.",
                 "project_q.", "quantizer.", "layer_norm_for_extract.")
_WAV2VEC2_HEADS = ("quantizer.", "project_q.", "final_proj.", "target_glu.0.", "proj.")


def backbone_keys(enc: EncoderConfig) -> Iterator[str]:
    """The state-dict keys of a port ``WavLM`` built from ``enc``: the
    standalone WavLM module tree's, which every fairseq-side model shares
    for its backbone."""
    for i in range(len(enc.conv_layers)):
        yield f"feature_extractor.conv_layers.{i}.0.weight"
        if enc.conv_bias:
            yield f"feature_extractor.conv_layers.{i}.0.bias"
        if enc.extractor_mode == "layer_norm":
            norm = f"feature_extractor.conv_layers.{i}.2.1"
        elif i == 0:
            norm = "feature_extractor.conv_layers.0.2"
        else:
            continue
        yield norm + ".weight"
        yield norm + ".bias"
    yield from ("layer_norm.weight", "layer_norm.bias")
    if enc.conv_layers[-1][0] != enc.encoder_embed_dim:
        yield from ("post_extract_proj.weight", "post_extract_proj.bias")
    yield "mask_emb"
    yield from ("encoder.pos_conv.0.weight_g", "encoder.pos_conv.0.weight_v",
                "encoder.pos_conv.0.bias", "encoder.layer_norm.weight",
                "encoder.layer_norm.bias")
    for i in range(enc.encoder_layers):
        pre = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield from (pre + f"self_attn.{proj}.weight", pre + f"self_attn.{proj}.bias")
        if enc.gru_rel_pos:
            yield from (pre + "self_attn.grep_linear.weight",
                        pre + "self_attn.grep_linear.bias", pre + "self_attn.grep_a")
        if enc.relative_position_embedding and i == 0:
            yield pre + "self_attn.relative_attention_bias.weight"
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            yield from (pre + f"{ln}.weight", pre + f"{ln}.bias")
        fc1 = pre + ("fc1.linear" if enc.activation_fn == "glu" else "fc1")
        yield from (fc1 + ".weight", fc1 + ".bias", pre + "fc2.weight", pre + "fc2.bias")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v, dtype=np.float32))


def _array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(v, dtype=np.float32)


def _is_head(key: str, heads) -> bool:
    return any(key == h or key.startswith(h) for h in heads)


def wavlm_state_dict_from_reference(sd: Mapping, enc: EncoderConfig,
                                    mask_emb: Optional[torch.Tensor] = None
                                    ) -> Dict[str, torch.Tensor]:
    """Port ``WavLM`` state dict (fp32 tensors) from a standalone-WavLM or
    fairseq-side state dict (tensors or ndarrays): the backbone's keys,
    every other key (pretraining heads, ``num_batches_tracked``) left out.

    ``mask_emb`` is absent in some fine-tuned exports: the embedding only
    replaces masked frames while pretraining. Pass the port model's own
    ``mask_emb`` then (``model.mask_emb``), and it is kept as the model
    has it; without one a missing ``mask_emb`` raises ``KeyError``."""
    out: Dict[str, torch.Tensor] = {}
    for key in backbone_keys(enc):
        if key == "mask_emb" and key not in sd and mask_emb is not None:
            out[key] = _tensor(mask_emb)
            continue
        if key not in sd:
            raise KeyError(f"the reference state dict has no {key}")
        out[key] = _tensor(sd[key])
    g = out["encoder.pos_conv.0.weight_g"]
    if g.dim() != 3 or g.shape[:2] != (1, 1) or g.shape[2] != enc.conv_pos:
        # weight_norm(..., dim=2) keeps one norm per kernel position
        raise ValueError(f"encoder.pos_conv.0.weight_g has shape {tuple(g.shape)}, "
                         f"not (1, 1, {enc.conv_pos})")
    return out


backbone_state_dict_from_fairseq = wavlm_state_dict_from_reference


def hubert_state_dict_from_fairseq(sd: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Port ``HubertPretrainModel`` state dict from a fairseq HubertModel /
    ILSHubertModel / WavLMModel / UniSpeechSATModel state dict (``cfg`` a
    HubertPretrainConfig): the backbone at the top level and the heads
    under their reference names (``label_embs_concat`` flat, ILS's
    ``final_proj.{i}``, ``target_glu.0``, SAT's ``spk_proj``,
    ``layer_norm_for_extract``, ``project_q`` and ``quantizer.*``)."""
    out = wavlm_state_dict_from_reference(sd, cfg.encoder)
    out.update({k: _tensor(v) for k, v in sd.items() if _is_head(k, _HUBERT_HEADS)})
    return out


def wav2vec2_state_dict_from_fairseq(sd: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """Port ``Wav2Vec2PretrainModel`` state dict from a fairseq
    Wav2Vec2Model / Unispeech state dict: the backbone, the quantizer
    (``weight_proj`` a single Linear or a Sequential's ``weight_proj.{2i}``),
    ``project_q``, ``final_proj``, ``target_glu.0`` and UniSpeech's CTC head
    ``proj``."""
    out = wavlm_state_dict_from_reference(sd, cfg.encoder)
    out.update({k: _tensor(v) for k, v in sd.items() if _is_head(k, _WAV2VEC2_HEADS)})
    return out


def strip_w2v_prefix(sd: Mapping) -> Dict:
    """The fine-tune wrapper's backbone, as the reference's warm-start
    loader reads it: the ``w2v_encoder.w2v_model.*`` keys, unprefixed."""
    return {k[len(W2V_PREFIX):]: v for k, v in sd.items() if k.startswith(W2V_PREFIX)}


def ctc_state_dict_from_fairseq(sd: Mapping, enc: EncoderConfig,
                                mask_emb: Optional[torch.Tensor] = None
                                ) -> Dict[str, torch.Tensor]:
    """Port ``CtcFinetuneModel`` state dict from a fairseq HubertCtc /
    Wav2VecCtc checkpoint: the backbone under ``wavlm.``, the vocabulary
    head ``w2v_encoder.proj`` as ``proj`` (``mask_emb`` as in
    ``wavlm_state_dict_from_reference``)."""
    backbone = wavlm_state_dict_from_reference(strip_w2v_prefix(sd), enc, mask_emb)
    out = {"wavlm." + k: v for k, v in backbone.items()}
    out["proj.weight"] = _tensor(sd["w2v_encoder.proj.weight"])
    out["proj.bias"] = _tensor(sd["w2v_encoder.proj.bias"])
    return out


def _backbone_to_reference(sd: Mapping, enc: EncoderConfig, prefix: str = ""
                           ) -> Dict[str, np.ndarray]:
    return {k: _array(sd[prefix + k]) for k in backbone_keys(enc)}


def hubert_to_fairseq(sd: Mapping, cfg) -> Dict[str, np.ndarray]:
    """A port ``HubertPretrainModel``'s ``state_dict()`` as the fairseq
    HubertModel / ILSHubertModel / UniSpeechSATModel state dict the JAX
    package's ``hubert_to_fairseq`` writes."""
    out = _backbone_to_reference(sd, cfg.encoder)
    out.update({k: _array(v) for k, v in sd.items() if _is_head(k, _HUBERT_HEADS)})
    return out


def wav2vec2_to_fairseq(sd: Mapping, cfg) -> Dict[str, np.ndarray]:
    """A port ``Wav2Vec2PretrainModel``'s ``state_dict()`` as the fairseq
    Wav2Vec2Model state dict (UniSpeech's CTC head as plain ``proj``)."""
    out = _backbone_to_reference(sd, cfg.encoder)
    out.update({k: _array(v) for k, v in sd.items() if _is_head(k, _WAV2VEC2_HEADS)})
    return out


def ctc_to_fairseq(sd: Mapping, cfg) -> Dict[str, np.ndarray]:
    """A port ``CtcFinetuneModel``'s ``state_dict()`` as a fairseq
    HubertCtc / Wav2VecCtc checkpoint: the backbone under
    ``w2v_encoder.w2v_model.``, the head at ``w2v_encoder.proj``."""
    backbone = _backbone_to_reference(sd, cfg.encoder, prefix="wavlm.")
    out = {W2V_PREFIX + k: v for k, v in backbone.items()}
    out["w2v_encoder.proj.weight"] = _array(sd["proj.weight"])
    out["w2v_encoder.proj.bias"] = _array(sd["proj.bias"])
    return out


def load_reference_checkpoint(path: str, trusted: bool = False
                              ) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """(state dict, config) of a reference ``.pt``: a dict whose ``model``
    entry is the state dict and whose ``cfg`` (or fairseq's older
    ``args``) entry is the config. The file is read with
    ``weights_only=True``; a fairseq checkpoint whose config is a pickled
    object fails that, and is read in full only when ``trusted`` (unpickling
    runs code from the file)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trusted:
            raise ValueError(f"{path} holds more than tensors and plain data; pass "
                             "trusted=True to unpickle it in full") from e
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, Mapping) or "model" not in ckpt:
        raise ValueError(f"{path} is not a reference checkpoint (no 'model' entry)")
    cfg = ckpt.get("cfg", ckpt.get("args"))
    return dict(ckpt["model"]), cfg


def save_reference_checkpoint(path: str, sd: Mapping, cfg: Optional[dict] = None) -> None:
    """Write ``{"model": sd, "cfg": cfg}`` with ``torch.save`` (tensors or
    ndarrays in ``sd``, stored as fp32 tensors): readable with
    ``weights_only=True`` when ``cfg`` is plain data."""
    torch.save({"model": {k: _tensor(v) for k, v in sd.items()}, "cfg": cfg}, path)
