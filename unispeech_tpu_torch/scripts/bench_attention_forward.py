"""Time the attention forward kernel on the card at the serving and the
pretraining shapes.

    python -m unispeech_tpu_torch.scripts.bench_attention_forward [--dtype fp32]

One call of ``fused_attention`` as WavLM-Base+ serving makes it (4
utterances padded to 799 frames, 12 heads of 64, the gated relative-position
bias, key padding) and one as WavLM-Base pretraining makes it (6 crops of 768
frames, attention dropout 0.1). For each it prints ms per call by CUDA events
around calls queued behind a busy card, the device time of the kernel alone
under ``torch.profiler``, and the largest error against the plain version
(relative to its largest value; in fp32 also the relative L2 distance).
``--dtype fp32``: the same in fp32, the models' default dtype (the fp32
kernel, ``csrc/flash_attention_f32.cu``). Inputs come from seed 0, so two builds of
the kernel can be compared in one run on one card (run the module from each
copy of the package). Needs a CUDA device.
"""

from __future__ import annotations

from typing import Dict

import torch

from unispeech_tpu_torch.ops.kernels import flash_attention
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias
from unispeech_tpu_torch.scripts.bench_attention_backward import DTYPES, kernel_ms, queued_ms

H, HD = 12, 64
ITERS = 50
NUM_BUCKETS, MAX_DISTANCE = 320, 800
CASES = {"serving": (4, 799, 0.0, True), "train_dropout": (6, 768, 0.1, False)}


def main(argv=None) -> Dict[str, float]:
    """Times the two cases and prints one line each; returns the kernel's
    device ms per call by case."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    args = p.parse_args(argv)
    dt = DTYPES[args.dtype]
    kernel = "flash_fwd_f32_kernel" if dt == torch.float32 else "flash_fwd_kernel"
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention_forward needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    res = {}
    for case, (B, T, rate, padded) in CASES.items():
        q, k, v = (torch.randn(B, T, H, HD, generator=g).to(dev, dt) for _ in range(3))
        table = (torch.randn(NUM_BUCKETS, H, generator=g) * 0.5).to(dev)
        kw = dict(bias=compute_rel_pos_bias(table, T, T, NUM_BUCKETS, MAX_DISTANCE,
                                            dtype=dt),
                  gate=(torch.rand(B, H, T, generator=g) * 2 + 1).to(dev))
        if padded:
            frames = torch.tensor([T - 200 * i for i in range(B)], device=dev)
            kw["key_padding_mask"] = torch.arange(T, device=dev)[None, :] >= frames[:, None]
        if rate:
            kw.update(dropout_rate=rate,
                      dropout_seed=torch.tensor([12345], dtype=torch.int64, device=dev))
        fn = lambda: flash_attention.fused_attention(q, k, v, **kw)  # noqa: E731
        want = flash_attention.fused_attention_plain(q, k, v, **kw).float()
        got = fn().float()
        err = float((got - want).abs().max() / want.abs().max())
        rel = float((got - want).norm() / want.norm())
        call = queued_ms(fn, ITERS)
        kern = kernel_ms(fn, ITERS, kernel)
        print(f"{case:13s} {args.dtype} call_ms={call:.4f} {kernel}_ms={kern:.4f} err={err:.2e} "
              f"rel_l2={rel:.2e} {card}", flush=True)
        res[case] = kern
    return res


if __name__ == "__main__":
    main()
