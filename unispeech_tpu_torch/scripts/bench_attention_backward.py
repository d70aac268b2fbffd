"""Time the attention backward kernel on the card at the pretraining shape.

    python -m unispeech_tpu_torch.scripts.bench_attention_backward [--shape xlarge]

One call of ``fused_attention_backward`` as WavLM-Base pretraining makes it
(6 crops of 768 frames, 12 heads of 64, the gated relative-position bias,
attention dropout 0.1, the last two rows padded by 68 and 168 frames), in
four cases: full, without dropout, without the gated bias, without either.
``--shape xlarge``: as HuBERT X-Large fine-tuning makes it on the padded
smoke batch (4 rows of 799 frames, 599/349/149 valid in three, 16 heads of
80; its path runs the case without the bias).
For each it prints ms per call by CUDA events around 20 calls queued behind
a busy card (the wrapper's zero fills and casts included), and the device
time of the backward kernel alone under ``torch.profiler``. Inputs come from seed 0, so two builds of the kernel can be
compared in one run on one card. Needs a CUDA device.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from unispeech_tpu_torch.ops.kernels import flash_attention
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

SHAPES = {  # (B, T, H, head dim, valid frames per row)
    "pretrain": (6, 768, 12, 64, (768,) * 4 + (700, 600)),
    "xlarge": (4, 799, 16, 80, (799, 599, 349, 149)),
}
ITERS = 20
NUM_BUCKETS, MAX_DISTANCE = 320, 800


def inputs(dev: torch.device, shape: str = "pretrain"):
    """(q, k, v, bias, gate, key padding, dropout seed, out, lse, dO) from seed 0."""
    B, T, H, HD, valid = SHAPES[shape]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, T, H, HD, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    table = (torch.randn(NUM_BUCKETS, H, generator=g) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table, T, T, NUM_BUCKETS, MAX_DISTANCE, dtype=torch.bfloat16)
    gate = (torch.rand(B, H, T, generator=g) * 2 + 1).to(dev)
    frames = torch.tensor(valid, device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    seed = torch.tensor([12345], dtype=torch.int64, device=dev)
    out, lse = flash_attention.fused_attention(q, k, v, bias=bias, gate=gate, key_padding_mask=kpm,
                                               dropout_rate=0.1, dropout_seed=seed,
                                               return_lse=True)
    dout = (torch.randn(B, T, H, HD, generator=g) * 1e-2).to(dev, torch.bfloat16)
    return q, k, v, bias, gate, kpm, seed, out, lse, dout


def queued_ms(fn, iters: int) -> float:
    """ms per call by CUDA events around calls queued behind a sleep kernel,
    so the host's gaps between launches do not count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    cycles = int(2 * (time.perf_counter() - t0) * 2e9)  # twice the enqueue, at >= 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int, name: str = "flash_bwd_kernel") -> float:
    """Device ms per call of the kernels whose names hold ``name`` (by
    default the backward kernel), under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / 1e3 / iters


def main(argv=None) -> Dict[str, float]:
    """Times the four cases and prints one line each; returns the kernel's
    device ms per call by case."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--shape", choices=sorted(SHAPES), default="pretrain")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention_backward needs a CUDA device")
    dev = torch.device("cuda")
    q, k, v, bias, gate, kpm, seed, out, lse, dout = inputs(dev, args.shape)
    cases = {"full": (bias, gate, 0.1, seed), "no_dropout": (bias, gate, 0.0, None),
             "no_bias": (None, None, 0.1, seed), "neither": (None, None, 0.0, None)}
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    res = {}
    for case, (bb, gg, rate, sd) in cases.items():
        fn = lambda: flash_attention.fused_attention_backward(  # noqa: E731
            q, k, v, bb, gg, kpm, None, rate, sd, out, lse, dout)
        call = queued_ms(fn, ITERS)
        kern = kernel_ms(fn, ITERS)
        print(f"{args.shape} {case:10s} call_ms={call:.4f} flash_bwd_kernel_ms={kern:.4f} "
              f"{card}", flush=True)
        res[case] = kern
    return res


if __name__ == "__main__":
    main()
