"""Elementwise micro-benchmark on the card: the cost of one pass over the
conv chain's largest activation.

Times one pass y = bf16(fn(x)) over a (6, 49152, 512) bf16 tensor (151M
elements, the L2 conv block's input at the pretraining crop) for seven
functions: copy, exp, the degree-8 and clamp-only degree-6 polynomial
GELUs, the Abramowitz-Stegun erf GELU with exp, the degree-8 GELU
derivative, and GELU + derivative. Counterpart of the JAX package's
``scripts/exp_vpu_micro.py``; the kernel is ``csrc/vpu_micro.cu``.

    python -m unispeech_tpu_torch.scripts.exp_vpu_micro [--shape B,T,C] [--iters N]
        [--device cuda|cpu]

Prints one line per variant: ms per pass, Gelem/s and, on the card, the
bytes bound (2 bytes read and 2 written per element at 3.35 TB/s), the
share of it reached and the card's name.
Runs on the card unless ``--device cpu`` is given, which runs the plain
versions (their CPU time is no device number).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Sequence

import torch

from unispeech_tpu_torch.ops.kernels import HBM_BYTES_PER_S, vpu_micro


def bound_ms(n: int) -> float:
    """Least time of one pass: each element read and written once in bf16."""
    return 1e3 * 4 * n / HBM_BYTES_PER_S


def time_ms(fn, x: torch.Tensor, iters: int) -> float:
    """ms per call after one warm-up: CUDA events on the card, the host
    clock on the CPU."""
    fn(x)
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(x.device)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        torch.cuda.synchronize(x.device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / iters


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    return device


def main(argv: Sequence[str] = None) -> Dict[str, float]:
    """Times every variant and prints its line; returns ms per pass by name."""
    p = argparse.ArgumentParser("unispeech_tpu_torch.scripts.exp_vpu_micro")
    p.add_argument("--shape", default="6,49152,512", help="B,T,C of the bf16 input")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = _device(args.device)
    shape = tuple(int(s) for s in args.shape.split(","))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    n = x.numel()
    b_ms = bound_ms(n)
    card = torch.cuda.get_device_name(device).replace(" ", "_") if x.is_cuda else None
    times = {}
    for name in vpu_micro.VARIANTS:
        dt = time_ms(lambda v, name=name: vpu_micro.run(name, v), x, args.iters)
        tail = (f"bound {b_ms:.3f} ms  share {b_ms / dt:.3f}  {card}" if x.is_cuda
                else "plain version on the CPU")
        print(f"{name:12s} {dt:7.3f} ms  ({n / dt / 1e6:6.1f} Gelem/s)  {tail}", flush=True)
        times[name] = dt
    return times


if __name__ == "__main__":
    main()
