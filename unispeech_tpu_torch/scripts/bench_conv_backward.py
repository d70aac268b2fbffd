"""Time the conv-block backward kernels on the card at the pretraining shape.

    python -m unispeech_tpu_torch.scripts.bench_conv_backward

One call of ``conv_gelu_block_backward`` for the first two blocks of the
WavLM-Base frontend as pretraining makes them (6 crops of 245,840 samples:
L2 on 49,167 input rows with the folded GroupNorm affine and the input GELU,
L3 on 24,583 rows without; k = 3, 512 channels, the output GELU). For each
it prints ms per call by CUDA events around calls queued behind a busy card,
the device time of each kernel (the g and H passes, dx, dW) under
``torch.profiler``, and the largest error of dx (relative to its largest
value) and the relative L2 error of dW against the plain version. Inputs
come from seed 0, so two builds of the kernels can be compared in one run on
one card (run the module from each copy of the package). Needs a CUDA
device.
"""

from __future__ import annotations

from typing import Dict

import torch

from unispeech_tpu_torch.ops.kernels import conv_stack
from unispeech_tpu_torch.scripts.bench_attention_backward import kernel_ms, queued_ms

B, C, K = 6, 512, 3
BLOCKS = {"L2": (49167, True), "L3": (24583, False)}  # input rows, first block
ITERS = 10
KERNELS = ("conv_bwd_g_kernel", "conv_h_kernel", "conv_bwd_dx_kernel", "conv_bwd_dw_kernel")


def main() -> Dict[str, float]:
    """Times the two blocks and prints one line each; returns ms per call."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_conv_backward needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    res = {}
    for name, (rows, first) in BLOCKS.items():
        x = torch.randn(B, rows, C, generator=g).to(dev, torch.bfloat16)
        w = (torch.randn(K, C, C, generator=g) * (2.0 / (K * C)) ** 0.5).to(dev, torch.bfloat16)
        ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
              (torch.randn(B, C, generator=g) * 0.1).to(dev)) if first else None
        _, t_out, pre = conv_stack.conv_gelu_block_plain(x, w, rows, first, True, ab,
                                                         return_pre=True)
        dy = (torch.randn(B, t_out, C, generator=g) * 1e-2).to(dev, torch.bfloat16)
        args = (x, w, rows, first, True, ab, dy, pre)
        got = conv_stack.conv_gelu_block_backward(*args)
        want = conv_stack.conv_gelu_block_backward_plain(*args)
        dx_err = float((got[0].float() - want[0].float()).abs().max()
                       / want[0].float().abs().max())
        dw_err = float((got[1] - want[1]).norm() / want[1].norm())
        del got, want
        fn = lambda: conv_stack.conv_gelu_block_backward(*args)  # noqa: E731
        call = queued_ms(fn, ITERS)
        parts = " ".join(f"{k}_ms={kernel_ms(fn, 1, k):.4f}" for k in KERNELS)
        print(f"{name} call_ms={call:.4f} {parts} dx_err={dx_err:.2e} dw_rel_l2={dw_err:.2e} "
              f"{card}", flush=True)
        res[name] = call
    return res


if __name__ == "__main__":
    main()
