"""CLI: ``python -m unispeech_tpu_torch.downstream.verification`` — speaker
verification trial scoring.

Counterpart of the JAX package's ``downstream/verification.py``: each
trial ("label path1 path2" per line, VoxCeleb style) embeds both
utterances with the WavLM backbone (bf16, every layer's output collected)
and the ECAPA-TDNN head (fp32), scores them by cosine, and the report is
the EER over the trial list. Each unique wav is embedded once: the wavs are
sorted by length and embedded ``--batch-size`` at a time, each batch
zero-padded to a multiple of 320 samples with its lengths as the padding
mask. ``--backbone`` and ``--head`` are params ``.npz`` files in the JAX
package's layout. Without ``--head`` the head is random (from seed 0; the
JAX CLI's random head differs), useful only for smoke runs. With it, the
BatchNorms keep flax's initial running averages, as the JAX CLI does.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch


def parse_trials(path: str) -> List[Tuple[int, str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            out.append((int(parts[0]), parts[1], parts[2]))
    return out


def encoder_config(arch: str, encoder_json=None):
    """The backbone config ``--arch`` builds (relative position bias with
    its gate, no dropout), with ``--encoder-json`` overrides."""
    from unispeech_tpu_torch.configs import (
        base_encoder_config,
        large_encoder_config,
        override_encoder,
    )

    enc_fn = base_encoder_config if arch == "base" else large_encoder_config
    return override_encoder(enc_fn(relative_position_embedding=True, gru_rel_pos=True,
                                   dropout=0.0, attention_dropout=0.0,
                                   encoder_layerdrop=0.0), encoder_json)


def load_backbone(path: str, enc, device):
    """A bf16 WavLM from a params ``.npz`` in the JAX layout, in eval mode
    on ``device``."""
    from unispeech_tpu_torch.configs import WavLMModelConfig
    from unispeech_tpu_torch.convert.from_jax import load_params_npz, wavlm_state_dict_from_jax
    from unispeech_tpu_torch.models.wavlm import WavLM

    model = WavLM(WavLMModelConfig(encoder=enc), dtype=torch.bfloat16)
    model.load_state_dict(wavlm_state_dict_from_jax(load_params_npz(path), enc), strict=True)
    return model.to(device).eval()


@torch.no_grad()
def embed_batch(backbone, head, src: torch.Tensor, lengths: torch.Tensor) -> np.ndarray:
    """(B, emb_dim) fp32 embeddings of a padded batch: one backbone forward
    collecting every layer's output, then the head with the padding mask."""
    out = backbone(src, lengths=lengths, collect_layer_outputs=True)
    return head(out.layer_outputs, out.padding_mask).float().cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("unispeech_tpu_torch.downstream.verification")
    p.add_argument("--trials", required=True, help="label path1 path2 lines")
    p.add_argument("--wav-root", default="", help="prefix for trial paths")
    p.add_argument("--backbone", required=True, help="pretrained params .npz")
    p.add_argument("--head", default=None,
                   help="ECAPA head params .npz (random init if absent: smoke runs only)")
    p.add_argument("--arch", choices=["base", "large"], default="base")
    p.add_argument("--encoder-json", default=None,
                   help="JSON EncoderConfig overrides (toy smoke tests)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-samples", type=int, default=16000 * 20)
    p.add_argument("--scores-path", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from unispeech_tpu_torch.convert.from_jax import ecapa_state_dict_from_jax, load_params_npz
    from unispeech_tpu_torch.data.manifest import load_audio
    from unispeech_tpu_torch.downstream.ecapa_tdnn import (
        EcapaConfig,
        EcapaTdnn,
        compute_eer,
        cosine_score,
    )
    from unispeech_tpu_torch.utils.device import device_or_raise

    device = device_or_raise(args.device)
    enc = encoder_config(args.arch, args.encoder_json)
    backbone = load_backbone(args.backbone, enc, device)
    head = EcapaTdnn(EcapaConfig(num_layer_feats=enc.encoder_layers + 1),
                     enc.encoder_embed_dim, generator=torch.Generator().manual_seed(0))
    if args.head:
        head.load_state_dict(ecapa_state_dict_from_jax(load_params_npz(args.head)), strict=True)
    head.to(device).eval()

    trials = parse_trials(args.trials)
    uniq = sorted({p for _, a, b in trials for p in (a, b)})

    def load(path):
        return load_audio(os.path.join(args.wav_root, path), 16_000)[:args.max_samples]

    sizes = {u: len(load(u)) for u in uniq}
    order = sorted(uniq, key=lambda u: sizes[u])
    embs: Dict[str, np.ndarray] = {}
    for i in range(0, len(order), args.batch_size):
        chunk = order[i:i + args.batch_size]
        wavs = [load(u) for u in chunk]
        T = int(np.ceil(max(len(w) for w in wavs) / 320) * 320)
        src = np.zeros((len(wavs), T), np.float32)
        lens = np.zeros((len(wavs),), np.int64)
        for r, w in enumerate(wavs):
            src[r, :len(w)] = w
            lens[r] = len(w)
        e = embed_batch(backbone, head, torch.from_numpy(src).to(device),
                        torch.from_numpy(lens).to(device))
        for r, u in enumerate(chunk):
            embs[u] = e[r]

    labels = np.asarray([t[0] for t in trials])
    scores = np.asarray([float(cosine_score(torch.from_numpy(embs[a]), torch.from_numpy(embs[b])))
                         for _, a, b in trials])
    eer = compute_eer(scores, labels)
    if args.scores_path:
        with open(args.scores_path, "w") as f:
            for (lab, a, b), s in zip(trials, scores):
                f.write(f"{s:.5f} {lab} {a} {b}\n")
    print(json.dumps({"trials": len(trials), "eer": round(eer * 100, 4)}))


if __name__ == "__main__":
    main()
