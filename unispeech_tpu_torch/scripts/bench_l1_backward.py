"""Time the L1 conv kernels on the card at the pretraining shape.

    python -m unispeech_tpu_torch.scripts.bench_l1_backward [--dtype fp32] [--variants] [--fma]

The first waveform conv layer as WavLM-Base pretraining runs it (6 crops of
245,840 samples, 512 channels, k = 10, stride 5: t1 = 49,167 rows), and the
backward once more at the (8, 4) geometry (t1 = 61,459). For the backward
(``l1_conv_backward`` with both sums' cotangents) it prints ms per call by
CUDA events around calls queued behind a busy card, the device time of the
kernel under ``torch.profiler`` (also without the sums' cotangents, which
skips the y1 recompute), its bytes bound and dW's error against the plain
version (bf16: relative L2; fp32: the largest difference over the sum of
|terms|, the rule of ``ops/kernels/sum_terms.py``); for the forward
(``l1_conv_with_stats``, one launch per train step) the same times and its
bound. ``--dtype fp32``: dy in fp32 (4 bytes in the bound) and the fp32
kernels of ``csrc/l1_frontend_f32.cu``. ``--variants`` (fp32): builds copies
of ``csrc/l1_frontend_f32.cu`` with one piece of the backward's work
removed each (``VARIANTS``), one library each, into the gitignored
``archive_check/l1_bwd_f32_variants/`` (``--variant-dir``), and times each
one's kernel in both forms by CUDA events: a variant that removes work
computes wrong values, its time says what the work costs. ``--fma``: the
CUDA cores' fp32 FMA rate with the fp32 backward's eight (and sixteen)
warps per SM, each thread running 40 independent FMA chains on registers:
what its consumers' arithmetic could reach. Inputs come from seed 0, so
two builds of the kernels can be compared in one run on one card (run the
module from each copy of the package). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
from typing import Dict, List, Tuple

import torch

from unispeech_tpu_torch.ops.kernels import HBM_BYTES_PER_S, _build, l1_frontend
from unispeech_tpu_torch.scripts.bench_attention_backward import kernel_ms, queued_ms

B, NS, C = 6, 245_840, 512
GEOMETRIES = {"k10s5": (10, 5), "k8s4": (8, 4)}
ITERS = 10
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
KERNELS = {"bf16": ("l1_conv_bwd_kernel", "l1_conv_fwd_kernel"),
           "fp32": ("l1_conv_bwd_f32_kernel", "l1_conv_fwd_f32_kernel")}

# gitignored, in the checkout
VARIANT_DIR = _build.PACKAGE_DIR.parent / "archive_check" / "l1_bwd_f32_variants"

# name -> [(text, replacement)] in csrc/l1_frontend_f32.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    # the dW FMAs (dy1 kept live by one add per channel and row)
    "no_dw_fmas": [(
        "            acc[j].x = fmaf(xv, d.x, acc[j].x);\n"
        "            acc[j].y = fmaf(xv, d.y, acc[j].y);\n"
        "            acc[j].z = fmaf(xv, d.z, acc[j].z);\n"
        "            acc[j].w = fmaf(xv, d.w, acc[j].w);\n",
        "            if (j == 0) acc[0] = make_float4(acc[0].x + d.x + xv, acc[0].y + d.y,\n"
        "                                             acc[0].z + d.z, acc[0].w + d.w);\n")],
    # the copies: the producer completes each stage's barrier without them,
    # the consumers compute on whatever the ring holds
    "no_copies": [(
        "                usk::mbar_expect_tx(&full[st], nr * C * 4 + x_boxes * kXBox * 4);\n"
        "                usk::bulk_load(stage, dy + ((size_t)b * t1 + t0) * C, nr * C * 4,"
        " &full[st]);\n"
        "                const int x0 = (b * ns + t0 * s) & ~3;\n"
        "                for (int xb = 0; xb < x_boxes; ++xb)\n"
        "                    usk::tma_load_1d(stage + dy_bytes + xb * kXBox * 4, &x_map,"
        " &full[st],\n"
        "                                     x0 + xb * kXBox);\n",
        "                usk::mbar_arrive(&full[st]);\n")],
    # all of the consumers' arithmetic: they wait for each stage and free it
    "copies_only": [("        if (active && nr > 0) {\n            const unsigned char* stage",
                     "        if (active && nr > 0 && acc[0].x == 1234.5f) {\n"
                     "            const unsigned char* stage")],
}


FMA_CU = r'''
#include <cuda_runtime.h>
__global__ void fma_chains(float* out, int iters, float a) {
    float acc[40];
#pragma unroll
    for (int j = 0; j < 40; ++j) acc[j] = threadIdx.x * 1e-3f + j;
    float x = a * threadIdx.x;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 40; ++j) acc[j] = fmaf(x, acc[j], 0.999f);
        x += 1e-7f;
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 40; ++j) sum += acc[j];
    out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int run_fma(int blocks, int threads, int iters, void* out, void* stream) {
    fma_chains<<<blocks, threads, 0, (cudaStream_t)stream>>>((float*)out, iters, 1.0001f);
    return (int)cudaGetLastError();
}
'''


def time_fma(out: pathlib.Path, card: str) -> None:
    """TFLOP/s of fp32 FMAs with 8 and 16 warps on every SM."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "fma.cu").write_text(FMA_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out / "libfma.so"),
                    str(out / "fma.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "libfma.so"))
    lib.run_fma.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 512, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    iters = 20_000
    for warps in (8, 16):
        ms = queued_ms(lambda: lib.run_fma(sms, 32 * warps, iters, buf.data_ptr(), st), 3)
        flops = sms * 32 * warps * iters * 40 * 2
        print(f"fma warps_per_sm={warps} tflops={flops / ms / 1e9:.1f} {card}", flush=True)


def backward_bound_ms(t1: int, k: int, esz: int, sums: bool = True) -> float:
    """Bytes of the backward: dy read once, the waveform, ds1/ds2 (with the
    sums' cotangents) and dW."""
    nbytes = B * t1 * C * esz + B * NS * 4 + (2 * B * C * 4 if sums else 0) + k * C * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S


def forward_bound_ms(t1: int, esz: int) -> float:
    """Bytes of the forward: the waveform read, y1 and the two sums written."""
    return 1e3 * (B * NS * 4 + B * t1 * C * esz + 2 * B * C * 4) / HBM_BYTES_PER_S


def dw_error(args, got, want, f32: bool) -> str:
    if not f32:
        return f"dw_rel_l2={float((got - want).norm() / want.norm()):.2e}"
    from unispeech_tpu_torch.ops.kernels.sum_terms import l1_terms, sum_error

    return f"dw_sum_err={sum_error(got, want, l1_terms(*args[:6])):.2e}"


def build_variants(out: pathlib.Path, names: List[str]) -> Dict[str, ctypes.CDLL]:
    """One library per variant of csrc/l1_frontend_f32.cu, nvcc all at once."""
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / "l1_frontend_f32.cu").read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS.get(name, []):
            if old not in src:
                raise ValueError(f"variant {name}: its text is not in l1_frontend_f32.cu")
            src = src.replace(old, new)
        cu, lib = out / f"{name}.cu", out / f"lib_{name}.so"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
               "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        (out / f"{name}.log").write_text(log)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].usk_l1_conv_bwd_f32.argtypes = l1_frontend._BWD_F32_SIGNATURE
    return libs


def time_variants(dev, out: pathlib.Path, card: str) -> None:
    """Each variant's kernel at the pretraining shape, with and without the
    sums' cotangents, ms per call by CUDA events."""
    libs = build_variants(out, ["as_is", *VARIANTS])
    g = torch.Generator().manual_seed(0)
    wav = (torch.randn(B, NS, generator=g) * 0.1).to(dev)
    k, s = GEOMETRIES["k10s5"]
    t1 = (NS - k) // s + 1
    w = (torch.randn(k, C, generator=g) * (2.0 / k) ** 0.5).to(dev)
    dy = (torch.randn(B, t1, C, generator=g) * 1e-3).to(dev)
    ds1 = (torch.randn(B, C, generator=g) * 1e-4).to(dev)
    ds2 = (torch.randn(B, C, generator=g) * 1e-4).to(dev)
    dw = torch.zeros(k, C, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = l1_frontend.bwd_f32_plan(B, t1, C, k, s, sms)
    st = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        for sums in (True, False):
            def run(lib=lib, sums=sums):
                err = lib.usk_l1_conv_bwd_f32(
                    wav.data_ptr(), w.data_ptr(), dy.data_ptr(),
                    ds1.data_ptr() if sums else None, ds2.data_ptr() if sums else None,
                    dw.data_ptr(), B, NS, t1, C, k, s, plan.rows, plan.stages, plan.grid,
                    plan.smem, st)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = queued_ms(run, ITERS)
            print(f"variant {name:12s} sums={int(sums)} kernel_ms={ms:.4f} "
                  f"bound_ms={backward_bound_ms(t1, k, 4, sums):.4f} {card}", flush=True)


def main(argv=None) -> Dict[str, float]:
    """Times both geometries and prints one line each; returns ms per call."""
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--variants", action="store_true",
                   help="fp32: time the kernel's variants instead")
    p.add_argument("--fma", action="store_true", help="time the CUDA cores' FMA rate instead")
    p.add_argument("--variant-dir", type=pathlib.Path, default=VARIANT_DIR,
                   help="where --variants and --fma build their libraries")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_l1_backward needs a CUDA device")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    if args.fma:
        time_fma(args.variant_dir, card)
        return {}
    if args.variants:
        time_variants(dev, args.variant_dir, card)
        return {}
    dt, f32 = DTYPES[args.dtype], args.dtype == "fp32"
    esz = 4 if f32 else 2
    bwd_kernel, fwd_kernel = KERNELS[args.dtype]
    g = torch.Generator().manual_seed(0)
    wav = (torch.randn(B, NS, generator=g) * 0.1).to(dev)
    res = {}
    for name, (k, s) in GEOMETRIES.items():
        t1 = (NS - k) // s + 1
        w = (torch.randn(k, 1, C, generator=g) * (2.0 / k) ** 0.5).to(dev)
        dy = (torch.randn(B, t1, C, generator=g) * 1e-3).to(dev, dt)
        ds1 = (torch.randn(B, C, generator=g) * 1e-4).to(dev)
        ds2 = (torch.randn(B, C, generator=g) * 1e-4).to(dev)
        l1_args = (wav, w, s, dy, ds1, ds2, dt)
        err = dw_error(l1_args, l1_frontend.l1_conv_backward(*l1_args),
                       l1_frontend.l1_conv_backward_plain(*l1_args), f32)
        fn = lambda: l1_frontend.l1_conv_backward(*l1_args)  # noqa: E731
        call = queued_ms(fn, ITERS)
        kern = kernel_ms(fn, ITERS, bwd_kernel)
        # without the sums' cotangents: no y1 recompute (attribution)
        no_sums = (wav, w, s, dy, None, None, dt)
        err_ns = dw_error(no_sums, l1_frontend.l1_conv_backward(*no_sums),
                          l1_frontend.l1_conv_backward_plain(*no_sums), f32)
        kern_dy = kernel_ms(lambda: l1_frontend.l1_conv_backward(*no_sums), ITERS, bwd_kernel)
        print(f"backward.{name} {args.dtype} t1={t1} call_ms={call:.4f} kernel_ms={kern:.4f} "
              f"kernel_ms_without_sums={kern_dy:.4f} bound_ms={backward_bound_ms(t1, k, esz):.4f} "
              f"bound_ms_without_sums={backward_bound_ms(t1, k, esz, False):.4f} "
              f"{err} without_sums_{err_ns} {card}", flush=True)
        res[f"backward.{name}"] = call
        if name == "k10s5":
            fwd = lambda: l1_frontend.l1_conv_with_stats(wav, w, s, dt)  # noqa: E731
            call = queued_ms(fwd, ITERS)
            kern = kernel_ms(fwd, ITERS, fwd_kernel)
            print(f"forward.{name} {args.dtype} t1={t1} call_ms={call:.4f} kernel_ms={kern:.4f} "
                  f"bound_ms={forward_bound_ms(t1, esz):.4f} {card}", flush=True)
            res[f"forward.{name}"] = call
        del dy
    return res


if __name__ == "__main__":
    main()
