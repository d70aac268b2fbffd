"""Time the conv-block kernels on the card at the pretraining shape.

    python -m unispeech_tpu_torch.scripts.bench_conv_backward [--dtype fp32]

One call of ``conv_gelu_block_backward`` for the first two blocks of the
WavLM-Base frontend as pretraining makes them (6 crops of 245,840 samples:
L2 on 49,167 input rows with the folded GroupNorm affine and the input GELU,
L3 on 24,583 rows without; k = 3, 512 channels, the output GELU), and one
call of ``conv_gelu_block`` (the forward, writing pre as autograd asks). For
each block it prints ms per call by CUDA events around calls queued behind
a busy card, the device time of each kernel (the g and H passes, dx, dW;
the forward's H pass and GEMM) under ``torch.profiler``, dx and dW alone as
the queued time of a call that launches one GEMM less that of a call that
launches neither (``backward_parts``), and the largest error of dx and of
the forward's y (relative to the largest value) and the relative L2 error of
dW against the plain version, with the card's name. ``--dtype fp32`` runs the
same in fp32, the models' default dtype (``csrc/conv_stack_f32.cu``).
Inputs come from seed 0, so two builds of the kernels can be compared in
one run on one card (run the module from each copy of the package). Needs a
CUDA device.
"""

from __future__ import annotations

from typing import Dict

import torch

from unispeech_tpu_torch.ops.kernels import conv_stack
from unispeech_tpu_torch.scripts.bench_attention_backward import kernel_ms, queued_ms

B, C, K = 6, 512, 3
BLOCKS = {"L2": (49167, True), "L3": (24583, False)}  # input rows, first block
ITERS = 10
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
KERNELS = {  # the backward's kernels, then the forward's, by dtype
    "bf16": (("conv_bwd_g_kernel", "conv_h_kernel", "conv_bwd_dx_kernel", "conv_bwd_dw_kernel"),
             ("conv_h_kernel", "conv_gemm_kernel")),
    "fp32": (("conv_bwd_g_f32_kernel", "conv_h_f32_kernel", "conv_bwd_dx_f32_kernel",
              "conv_bwd_dw_f32_kernel"), ("conv_h_f32_kernel", "conv_gemm_f32_kernel")),
}


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def main(argv=None) -> Dict[str, float]:
    """Times the two blocks and prints two lines each (backward, forward);
    returns the backward's ms per call by block."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_conv_backward needs a CUDA device")
    dev = torch.device("cuda")
    dt = DTYPES[args.dtype]
    bwd_kernels, fwd_kernels = KERNELS[args.dtype]
    g = torch.Generator().manual_seed(0)
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    res = {}
    for name, (rows, first) in BLOCKS.items():
        x = torch.randn(B, rows, C, generator=g).to(dev, dt)
        w = (torch.randn(K, C, C, generator=g) * (2.0 / (K * C)) ** 0.5).to(dev, dt)
        ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
              (torch.randn(B, C, generator=g) * 0.1).to(dev)) if first else None
        py, t_out, pre = conv_stack.conv_gelu_block_plain(x, w, rows, first, True, ab,
                                                          return_pre=True)
        dy = (torch.randn(B, t_out, C, generator=g) * 1e-2).to(dev, dt)
        args_b = (x, w, rows, first, True, ab, dy, pre)
        got = conv_stack.conv_gelu_block_backward(*args_b)
        want = conv_stack.conv_gelu_block_backward_plain(*args_b)
        dx_err = _max_err(got[0], want[0])
        dw_err = float((got[1] - want[1]).norm() / want[1].norm())
        del got, want
        fn = lambda: conv_stack.conv_gelu_block_backward(*args_b)  # noqa: E731
        call = queued_ms(fn, ITERS)
        parts = " ".join(f"{k}_ms={kernel_ms(fn, 1, k):.4f}" for k in bwd_kernels)
        base = queued_ms(lambda: conv_stack.backward_parts(*args_b, 0), ITERS)
        split = " ".join(
            f"{tag}_alone_ms={queued_ms(lambda: conv_stack.backward_parts(*args_b, bit), ITERS) - base:.4f}"
            for tag, bit in (("dx", conv_stack.BWD_DX), ("dw", conv_stack.BWD_DW)))
        print(f"{name} {args.dtype} backward call_ms={call:.4f} {parts} {split} "
              f"dx_err={dx_err:.2e} dw_rel_l2={dw_err:.2e} {card}", flush=True)
        res[name] = call
        fwd = lambda: conv_stack._forward(x, w, rows, first, True, ab, True)  # noqa: E731
        y_err = _max_err(fwd()[0], py)
        fparts = " ".join(f"{k}_ms={kernel_ms(fwd, 1, k):.4f}" for k in fwd_kernels)
        print(f"{name} {args.dtype} forward call_ms={queued_ms(fwd, ITERS):.4f} {fparts} "
              f"y_err={y_err:.2e} {card}", flush=True)
    return res


if __name__ == "__main__":
    main()
