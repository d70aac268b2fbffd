"""Time the L1 conv kernels on the card at the pretraining shape.

    python -m unispeech_tpu_torch.scripts.bench_l1_backward

The first waveform conv layer as WavLM-Base pretraining runs it (6 crops of
245,840 samples, 512 channels, k = 10, stride 5: t1 = 49,167 rows), and the
backward once more at the (8, 4) geometry (t1 = 61,459). For the backward
(``l1_conv_backward`` with both sums' cotangents) it prints ms per call by
CUDA events around calls queued behind a busy card, the device time of the
kernel under ``torch.profiler`` (also without the sums' cotangents, which
skips the y1 recompute), its bytes bound and the relative L2 error of dW
against the plain version; for the forward (``l1_conv_with_stats``, one
launch per train step) the same times and its bound. Inputs come from
seed 0, so two builds of the kernels can be compared in one run on one
card (run the module from each copy of the package). Needs a CUDA device.
"""

from __future__ import annotations

from typing import Dict

import torch

from unispeech_tpu_torch.ops.kernels import HBM_BYTES_PER_S, l1_frontend
from unispeech_tpu_torch.scripts.bench_attention_backward import kernel_ms, queued_ms

B, NS, C = 6, 245_840, 512
GEOMETRIES = {"k10s5": (10, 5), "k8s4": (8, 4)}
ITERS = 10


def backward_bound_ms(t1: int, k: int) -> float:
    """Bytes of the backward: dy read once, the waveform, ds1/ds2 and dW."""
    return 1e3 * (B * t1 * C * 2 + B * NS * 4 + 2 * B * C * 4 + k * C * 4) / HBM_BYTES_PER_S


def forward_bound_ms(t1: int) -> float:
    """Bytes of the forward: the waveform read, y1 and the two sums written."""
    return 1e3 * (B * NS * 4 + B * t1 * C * 2 + 2 * B * C * 4) / HBM_BYTES_PER_S


def main() -> Dict[str, float]:
    """Times both geometries and prints one line each; returns ms per call."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_l1_backward needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    wav = (torch.randn(B, NS, generator=g) * 0.1).to(dev)
    res = {}
    for name, (k, s) in GEOMETRIES.items():
        t1 = (NS - k) // s + 1
        w = (torch.randn(k, 1, C, generator=g) * (2.0 / k) ** 0.5).to(dev)
        dy = (torch.randn(B, t1, C, generator=g) * 1e-3).to(dev, torch.bfloat16)
        ds1 = (torch.randn(B, C, generator=g) * 1e-4).to(dev)
        ds2 = (torch.randn(B, C, generator=g) * 1e-4).to(dev)
        args = (wav, w, s, dy, ds1, ds2)
        got = l1_frontend.l1_conv_backward(*args)
        want = l1_frontend.l1_conv_backward_plain(*args)
        err = float((got - want).norm() / want.norm())
        del got, want
        fn = lambda: l1_frontend.l1_conv_backward(*args)  # noqa: E731
        call = queued_ms(fn, ITERS)
        kern = kernel_ms(fn, ITERS, "l1_conv_bwd_kernel")
        # without the sums' cotangents: no y1 recompute (attribution)
        plain_dy = lambda: l1_frontend.l1_conv_backward(wav, w, s, dy)  # noqa: E731
        kern_dy = kernel_ms(plain_dy, ITERS, "l1_conv_bwd_kernel")
        print(f"backward.{name} t1={t1} call_ms={call:.4f} kernel_ms={kern:.4f} "
              f"kernel_ms_without_sums={kern_dy:.4f} bound_ms={backward_bound_ms(t1, k):.4f} "
              f"dw_rel_l2={err:.2e} {card}", flush=True)
        res[f"backward.{name}"] = call
        if name == "k10s5":
            fwd = lambda: l1_frontend.l1_conv_with_stats(wav, w, s)  # noqa: E731
            call = queued_ms(fwd, ITERS)
            kern = kernel_ms(fwd, ITERS, "l1_conv_fwd_kernel")
            print(f"forward.{name} t1={t1} call_ms={call:.4f} kernel_ms={kern:.4f} "
                  f"bound_ms={forward_bound_ms(t1):.4f} {card}", flush=True)
            res[f"forward.{name}"] = call
        del dy
    return res


if __name__ == "__main__":
    main()
