"""Time the L1 conv forward kernel on the card, with and without its sums.

    python -m unispeech_tpu_torch.scripts.bench_l1_forward

The first waveform conv layer (``l1_conv_with_stats``, 512 channels) at the
serving shape (4 x 256,000 samples: t1 = 51,199 rows at k = 10, stride 5)
and at the pretraining shape (6 x 245,840: t1 = 49,167), each at (k,
stride) = (10, 5) and (8, 4), with the GroupNorm sums and without them (the
``layer_norm`` extractor's call). Per case it prints the device ms per call
(CUDA events around calls queued behind a sleep kernel, so the host's gaps
between launches do not count), the bytes bound and the share of it, the
device ms of ``F.conv1d`` on the same bf16 waveform and taps (one PyTorch
call for y1 without the sums), and y1's largest error against the plain
version in bf16 ulps at its scale. Inputs come from seed 0, so two builds of
the kernel can be compared in one run on one card (run the module from each
copy of the package); a build whose wrapper has no ``with_stats`` prints
its no-sums cases as n/a. Per shape it also prints the device ms of
``fill_`` on a tensor of y1's size and type, the library's own pure write
of the bytes that bound the kernel. Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import subprocess
from typing import Dict

import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.kernels import HBM_BYTES_PER_S, l1_frontend
from unispeech_tpu_torch.scripts.bench_attention_backward import queued_ms

C = 512
SHAPES = {"serving": (4, 256_000), "pretraining": (6, 245_840)}
GEOMETRIES = {"k10s5": (10, 5), "k8s4": (8, 4)}
ITERS = 20


def bound_ms(B: int, NS: int, t1: int, with_stats: bool) -> float:
    """Bytes of the forward: the waveform read, y1 (and the two sums) written."""
    return 1e3 * (B * NS * 4 + B * t1 * C * 2 + (2 * B * C * 4 if with_stats else 0)) \
        / HBM_BYTES_PER_S


def main() -> Dict[str, float]:
    """Times every case and prints one line each; returns device ms per call."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_l1_forward needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(dev), flush=True)
    has_flag = "with_stats" in inspect.signature(l1_frontend.l1_conv_with_stats).parameters
    g = torch.Generator().manual_seed(0)
    res = {}
    for shape, (B, NS) in SHAPES.items():
        wav = (torch.randn(B, NS, generator=g) * 0.1).to(dev)
        for geo, (k, s) in GEOMETRIES.items():
            t1 = (NS - k) // s + 1
            w = (torch.randn(k, 1, C, generator=g) * (2.0 / k) ** 0.5).to(dev)
            want = l1_frontend.l1_conv_with_stats_plain(wav, w, s)[0].float()
            ulp = 2.0 ** -7 * float(want.abs().max())
            xb, wl = wav.to(torch.bfloat16)[:, None, :], w.permute(2, 1, 0).to(torch.bfloat16)
            lib = queued_ms(lambda: F.conv1d(xb, wl, stride=s), ITERS)
            out = torch.empty(B, t1, C, device=dev, dtype=torch.bfloat16)
            fill = queued_ms(lambda: out.fill_(1.0), ITERS)
            print(f"{shape}.{geo} t1={t1} fill_device_ms={fill:.4f} "
                  f"write_share={1e3 * B * t1 * C * 2 / HBM_BYTES_PER_S / fill:.3f}", flush=True)
            del out
            for stats in (True, False):
                name = f"{shape}.{geo}.{'sums' if stats else 'no_sums'}"
                b_ms = bound_ms(B, NS, t1, stats)
                if not stats and not has_flag:
                    print(f"{name} t1={t1} device_ms=n/a bound_ms={b_ms:.4f}", flush=True)
                    continue
                kw = {} if stats else {"with_stats": False}
                fn = lambda: l1_frontend.l1_conv_with_stats(wav, w, s, **kw)  # noqa: E731
                err = float((fn()[0].float() - want).abs().max()) / ulp
                ms = queued_ms(fn, ITERS)
                print(f"{name} t1={t1} device_ms={ms:.4f} bound_ms={b_ms:.4f} "
                      f"bound_share={b_ms / ms:.3f} conv1d_device_ms={lib:.4f} "
                      f"y1_err_ulps={err:.3f}", flush=True)
                res[name] = ms
            del want
    return res


if __name__ == "__main__":
    main()
