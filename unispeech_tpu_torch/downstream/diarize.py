"""CLI: ``python -m unispeech_tpu_torch.downstream.diarize`` — speaker
diarization of whole recordings, with an optional DER.

Counterpart of the JAX package's ``downstream/diarize.py``: each recording
of the ``--manifest`` TSV, zero-padded to a multiple of 320 samples, goes
through one WavLM backbone forward (bf16) whole; the EEND head (fp32) then
runs chunk by chunk (``--chunk-frames``), AHC joins the chunks' speakers,
a median filter smooths the activity, and one RTTM per recording goes to
``--rttm-dir``. With ``--ref-rttm`` the report adds the mean DER (in %)
over the recordings the reference covers. ``--backbone`` and ``--head``
are params ``.npz`` files in the JAX package's layout; without ``--head``
the head is random (from seed 0), useful only for smoke runs. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from unispeech_tpu_torch.downstream.diarization import (
    DiarizationConfig,
    TransformerDiarization,
    chunked_diarization,
    compute_der,
    to_rttm,
)


@torch.no_grad()
def recording_features(backbone, wav: np.ndarray, device) -> np.ndarray:
    """(T, D) fp32 features of one recording, padded to a multiple of 320
    samples so that the frame count is exact: one backbone forward."""
    n = int(np.ceil(len(wav) / 320) * 320)
    src = np.zeros((1, n), np.float32)
    src[0, :len(wav)] = wav
    return backbone(torch.from_numpy(src).to(device)).x[0].float().cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("unispeech_tpu_torch.downstream.diarize")
    p.add_argument("--manifest", required=True, help="TSV of recordings")
    p.add_argument("--backbone", required=True, help="pretrained params .npz")
    p.add_argument("--head", default=None,
                   help="diarization head params .npz (random init if absent: smoke runs only)")
    p.add_argument("--arch", choices=["base", "large"], default="base")
    p.add_argument("--encoder-json", default=None)
    p.add_argument("--chunk-frames", type=int, default=2000)
    p.add_argument("--num-speakers", type=int, default=3)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--median-width", type=int, default=11)
    p.add_argument("--rttm-dir", default=None)
    p.add_argument("--ref-rttm", default=None, help="reference RTTM to score")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from unispeech_tpu_torch.convert.from_jax import (
        diarization_state_dict_from_jax,
        load_params_npz,
    )
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio
    from unispeech_tpu_torch.downstream.verification import encoder_config, load_backbone
    from unispeech_tpu_torch.utils.device import device_or_raise

    device = device_or_raise(args.device)
    enc = encoder_config(args.arch, args.encoder_json)
    backbone = load_backbone(args.backbone, enc, device)
    head = TransformerDiarization(DiarizationConfig(num_speakers=args.num_speakers),
                                  enc.encoder_embed_dim,
                                  generator=torch.Generator().manual_seed(0))
    if args.head:
        head.load_state_dict(diarization_state_dict_from_jax(load_params_npz(args.head)),
                             strict=True)
    head.to(device).eval()

    @torch.no_grad()
    def head_infer(feats: np.ndarray):
        out = head(torch.from_numpy(feats).to(device)[None])
        return out.logits[0].cpu().numpy(), out.spk_vectors[0].cpu().numpy()

    man = Manifest.load(args.manifest)
    frame_shift = enc.frame_hop / 16_000.0
    results, hyp_rttms = {}, {}
    for i in range(len(man)):
        feats = recording_features(backbone, load_audio(man.abspath(i), 16_000), device)
        act = chunked_diarization(head_infer, feats, chunk_size=args.chunk_frames,
                                  threshold=args.threshold, median_width=args.median_width)
        uri = os.path.splitext(os.path.basename(man.paths[i]))[0]
        rttm = to_rttm(act.astype(int), frame_shift, uri=uri)
        hyp_rttms[uri] = rttm
        results[uri] = {"speakers": int(act.shape[1]), "frames": int(act.shape[0])}
        if args.rttm_dir:
            os.makedirs(args.rttm_dir, exist_ok=True)
            with open(os.path.join(args.rttm_dir, f"{uri}.rttm"), "w") as f:
                f.write(rttm + "\n")

    report = {"recordings": len(results)}
    if args.ref_rttm:
        with open(args.ref_rttm) as f:
            ref_all = f.read()
        ders = []
        for uri, rttm in hyp_rttms.items():
            ref_lines = "\n".join(l for l in ref_all.splitlines() if f" {uri} " in l)
            if ref_lines:
                ders.append(compute_der(ref_lines, rttm)["der"])
        if ders:
            report["der"] = round(float(np.mean(ders)) * 100, 3)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
