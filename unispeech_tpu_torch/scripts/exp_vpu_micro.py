"""Elementwise micro-benchmark on the card: the cost of one pass over the
conv chain's largest activation.

Times one pass y = bf16(fn(x)) over a (6, 49152, 512) bf16 tensor (151M
elements, the L2 conv block's input at the pretraining crop) for seven
functions: copy, exp, the degree-8 and clamp-only degree-6 polynomial
GELUs, the Abramowitz-Stegun erf GELU with exp, the degree-8 GELU
derivative, and GELU + derivative. Counterpart of the JAX package's
``scripts/exp_vpu_micro.py``; the kernel is ``csrc/vpu_micro.cu``.

    python -m unispeech_tpu_torch.scripts.exp_vpu_micro [--shape B,T,C] [--iters N]
        [--device cuda|cpu] [--sass]

Prints one line per variant: ms per pass, Gelem/s and, on the card, the
bytes bound (2 bytes read and 2 written per element at 3.35 TB/s), the
share of it reached and the card's name. ``--sass`` adds, per variant, the
instructions of its kernel in the built library (``cuobjdump -sass``), the
instructions per element beyond the copy kernel's and the arithmetic bound
they give at one instruction per lane and cycle (67 TFLOP/s fp32 counts an
FMA as two operations: 33.5e12 lane-instructions per second).
Runs on the card unless ``--device cpu`` is given, which runs the plain
versions (their CPU time is no device number).
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import time
from typing import Dict, Sequence

import torch

from unispeech_tpu_torch.ops.kernels import FP32_FLOPS, HBM_BYTES_PER_S, _build, vpu_micro

# copies of the function in a register-stream kernel (csrc/vpu_micro.cu):
# its unrolled 16-byte vectors of 8 elements and the scalar tail
FUNCTION_COPIES = 8 * 2 + 1


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


def sass_counts() -> Dict[str, tuple]:
    """(kernel, instructions) of each variant's kernel in the built library,
    NOPs aside, by ``cuobjdump -sass`` from the toolkit that built it."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], check=True,
                          capture_output=True, text=True).stdout
    names = list(vpu_micro.VARIANTS)
    counts: Dict[str, list] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            head = re.search(r"(vpu_(?:micro|ring)_kernel)ILi(\d)E", line)
            current = names[int(head.group(2))] if head else None
            if current is not None:
                counts[current] = [head.group(1), 0]
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current is not None and op and op.group(2) != "NOP":
            counts[current][1] += 1
    return {name: tuple(v) for name, v in counts.items()}


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
    p.add_argument("--sass", action="store_true",
                   help="also count each kernel's instructions (needs cuobjdump)")
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
    if args.sass:
        counts = sass_counts()
        for name, (kernel, c) in counts.items():
            line = f"{name:12s} {kernel} sass_instructions={c}"
            if kernel == "vpu_micro_kernel":  # the register stream: per element
                per_elem = (c - counts["copy"][1]) / FUNCTION_COPIES
                arith_ms = 1e3 * n * per_elem / (FP32_FLOPS / 2)
                line += (f" beyond_copy_per_element={per_elem:.1f}"
                         f" arithmetic_bound_ms={arith_ms:.4f}")
            print(line, flush=True)
    return times


if __name__ == "__main__":
    main()
