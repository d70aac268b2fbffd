"""Time the attention backward kernel on the card at the pretraining shape.

    python -m unispeech_tpu_torch.scripts.bench_attention_backward [--shape xlarge|xlsr2b] [--dtype fp32]

One call of ``fused_attention_backward`` as WavLM-Base pretraining makes it
(6 crops of 768 frames, 12 heads of 64, the gated relative-position bias,
attention dropout 0.1, the last two rows padded by 68 and 168 frames), in
four cases: full, without dropout, without the gated bias, without either.
``--shape xlarge``: as HuBERT X-Large fine-tuning makes it on the padded
smoke batch (4 rows of 799 frames, 599/349/149 valid in three, 16 heads of
80; its path runs the case without the bias). ``--shape xlsr2b``: the same
at XLS-R 2B's 16 heads of 120 (fp32 CTC fine-tuning at that width runs the
case without the bias).
``--dtype fp32``: the same in fp32, the models' default dtype (the fp32
kernel, ``csrc/flash_attention_bwd_f32.cu``, at the width
``flash_attention.f32_width`` gives the head dim: 64 at the
pretraining shape, 80 at X-Large's, 128 at XLS-R 2B's), with each output's relative L2
distance to the plain version.
For each it prints ms per call by CUDA events around 20 calls queued behind
a busy card (the wrapper's zero fills and casts included), the device
time of the backward kernel alone under ``torch.profiler`` and the bound:
the bytes (q, k, v, out, dO read, dq, dk, dv written, the bias read and
its gradient written, lse, delta, the key mask) at 3.35 TB/s, or the
operations (10 H T keys hd over the valid keys; in fp32 three TF32
products each at the TF32 peak) at the tensor cores' peak, whichever is
longer, and the same backward by one PyTorch call as a yardstick
(``sdpa_bwd_ms``: ``torch.autograd.grad`` of
``F.scaled_dot_product_attention`` with the same mask, bias and dropout
rate, its own dropout draws), by CUDA events as above. Inputs come from seed 0, so two builds of the kernel can be
compared in one run on one card. Needs a CUDA device.
"""

from __future__ import annotations

import time
from typing import Dict

import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.kernels import (
    BF16_TC_FLOPS,
    HBM_BYTES_PER_S,
    TF32_TC_FLOPS,
    flash_attention,
)
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

SHAPES = {  # (B, T, H, head dim, valid frames per row)
    "pretrain": (6, 768, 12, 64, (768,) * 4 + (700, 600)),
    "xlarge": (4, 799, 16, 80, (799, 599, 349, 149)),
    "xlsr2b": (4, 799, 16, 120, (799, 599, 349, 149)),
}
ITERS = 20
NUM_BUCKETS, MAX_DISTANCE = 320, 800


DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def inputs(dev: torch.device, shape: str = "pretrain", dtype: torch.dtype = torch.bfloat16):
    """(q, k, v, bias, gate, key padding, dropout seed, out, lse, dO) from seed 0."""
    B, T, H, HD, valid = SHAPES[shape]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, T, H, HD, generator=g).to(dev, dtype) for _ in range(3))
    table = (torch.randn(NUM_BUCKETS, H, generator=g) * 0.5).to(dev)
    bias = compute_rel_pos_bias(table, T, T, NUM_BUCKETS, MAX_DISTANCE, dtype=dtype)
    gate = (torch.rand(B, H, T, generator=g) * 2 + 1).to(dev)
    frames = torch.tensor(valid, device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= frames[:, None]
    seed = torch.tensor([12345], dtype=torch.int64, device=dev)
    out, lse = flash_attention.fused_attention(q, k, v, bias=bias, gate=gate, key_padding_mask=kpm,
                                               dropout_rate=0.1, dropout_seed=seed,
                                               return_lse=True)
    dout = (torch.randn(B, T, H, HD, generator=g) * 1e-2).to(dev, dtype)
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


def bound_ms(shape: str, esz: int, bias: bool) -> float:
    """The least time of one backward call: bytes or operations."""
    B, T, H, HD, valid = SHAPES[shape]
    nbytes = 8 * B * T * H * HD * esz + 3 * B * H * T * 4 + B * T
    nbytes += 2 * H * T * T * esz if bias else 0
    mult, peak = (3, TF32_TC_FLOPS) if esz == 4 else (1, BF16_TC_FLOPS)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, mult * 10 * H * T * sum(valid) * HD / peak)


def library_backward(q, k, v, bias, gate, kpm, rate, dout):
    """A closure computing the same backward by SDPA's autograd: the mask is
    the gated bias plus the key padding (a boolean key mask without bias)."""
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    if bias is None:
        mask = ~kpm[:, None, None, :]
        inputs = (qh, kh, vh)
    else:
        mask = (gate[..., None] * bias.float()[None]
                + torch.where(kpm, -1e30, 0.0)[:, None, None, :]).to(q.dtype).requires_grad_()
        inputs = (qh, kh, vh, mask)
    y = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=rate)
    grad = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(y, inputs, grad, retain_graph=True)


def main(argv=None) -> Dict[str, float]:
    """Times the four cases and prints one line each; returns the kernel's
    device ms per call by case."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--shape", choices=sorted(SHAPES), default="pretrain")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention_backward needs a CUDA device")
    dev = torch.device("cuda")
    f32 = args.dtype == "fp32"
    kernel = "flash_bwd_f32" if f32 else "flash_bwd_kernel"
    q, k, v, bias, gate, kpm, seed, out, lse, dout = inputs(dev, args.shape, DTYPES[args.dtype])
    cases = {"full": (bias, gate, 0.1, seed), "no_dropout": (bias, gate, 0.0, None),
             "no_bias": (None, None, 0.1, seed), "neither": (None, None, 0.0, None)}
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    hd = SHAPES[args.shape][3]
    width = f" width={flash_attention.f32_width(hd)}" if f32 else ""
    res = {}
    for case, (bb, gg, rate, sd) in cases.items():
        fn = lambda: flash_attention.fused_attention_backward(  # noqa: E731
            q, k, v, bb, gg, kpm, None, rate, sd, out, lse, dout)
        err = ""
        if f32:  # each output's relative L2 distance to the plain version
            want = flash_attention.fused_attention_backward_plain(
                q, k, v, bb, gg, kpm, None, rate, sd, out, lse, dout)
            err = " rel_l2=" + ",".join(
                f"{float((x - y).norm() / y.norm()):.2e}"
                for x, y in zip(fn(), want) if y is not None)
        call = queued_ms(fn, ITERS)
        kern = kernel_ms(fn, ITERS, kernel)
        sdpa = queued_ms(library_backward(q, k, v, bb, gg, kpm, rate, dout), ITERS)
        print(f"{args.shape} {args.dtype} {case:10s} call_ms={call:.4f} {kernel}_ms={kern:.4f}"
              f" bound_ms={bound_ms(args.shape, 4 if f32 else 2, bb is not None):.4f}"
              f" sdpa_bwd_ms={sdpa:.4f}{width}"
              f"{err} {card}", flush=True)
        res[case] = kern
    return res


if __name__ == "__main__":
    main()
