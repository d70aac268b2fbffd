"""Where the fp32 conv-block GEMMs spend their time: variants with one piece removed.

    python -m unispeech_tpu_torch.scripts.exp_conv_f32_variants [VARIANT ...]
    python -m unispeech_tpu_torch.scripts.exp_conv_f32_variants --source copy.cu
    python -m unispeech_tpu_torch.scripts.exp_conv_f32_variants --products

Builds ``csrc/conv_stack_f32.cu`` (or ``--source``, another copy of it with
the same C entries) once as it is and once per named variant, a text
substitution that removes one piece of the kernels' work, each into its own
library under ``_build/variants/``, and times the forward (with the H pass
where it runs), dx and dW of the WavLM-Base pretraining blocks L2 (49,167
input rows, the affine and the input GELU) and L3 (24,583 rows) by CUDA
events, with each output's relative L2 distance to the plain version. A
variant that removes work computes wrong values; its time says what that
work costs. ``--products`` times a kernel that runs only the GEMMs'
products (per stage three TF32 ``wgmma.m64n128k8`` per k8 step into a fresh
sum, added into a running one) on shared-memory data, at one to three
warpgroups per SM: the tensor cores' rate without loads or splits. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from unispeech_tpu_torch.ops.kernels import _build, conv_stack

CSRC = _build.CSRC_DIR
OUT = _build.BUILD_DIR / "variants"
B, C, K = 6, 512, 3
BLOCKS = {"L2": (49167, True), "L3": (24583, False)}  # input rows, first block
ITERS = 10

# name -> [(text, replacement)] in conv_stack_f32.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    # B's loads from L2 (its split and stores stay)
    "no_b_loads": [
        ("v[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(u >> 3) * ld + k0 + 4 * (u & 7)));",
         "v[i] = make_float4((float)k0, (float)u, 1.f, (float)ld);"),
        ("v[r] = t + r < t_out ? __ldg(reinterpret_cast<const float4*>(src + (size_t)r * C))\n"
         "                                 : make_float4(0.f, 0.f, 0.f, 0.f);",
         "v[r] = make_float4((float)t, (float)r, 1.f, 2.f);")],
    # A's TMA loads (the slot's barrier completes without them)
    "no_a_loads": [
        ("        usk::mbar_expect_tx(&ring.full[s], kTile);\n        op.load_a(j, slot, &ring.full[s]);",
         "        usk::mbar_arrive(&ring.full[s]);")],
    # the fresh sums' adds into the running sums
    "no_adds": [("        for (int i = 0; i < 64; ++i) acc[i] += t[i];",
                 "        for (int i = 0; i < 64; ++i) acc[i] = t[i];")],
    # the epilogues
    "no_epilogue": [("op.epilogue(acc, ks, ring);",
                     "if (acc[0] == 1234.5f) op.epilogue(acc, ks, ring);")],
    # dx's da/db global adds, and its gelu'(x^)
    "no_dadb_adds": [("                atomicAdd(((gq & 2) ? db : da) + (size_t)b * C + col, total);",
                      "                if (total == 1234.5f) atomicAdd(((gq & 2) ? db : da) + (size_t)b * C + col, total);")],
    "no_dgelu": [("                            v0 = __fmul_rn(v0, usk::dgelu_erf(h0));\n"
                  "                            v1 = __fmul_rn(v1, usk::dgelu_erf(h1));",
                  "                            v0 = __fmul_rn(v0, h0);\n"
                  "                            v1 = __fmul_rn(v1, h1);")],
}

PRODUCTS_CU = r'''
#include "hopper.cuh"
#include "tf32.cuh"
__global__ void __launch_bounds__(128, 1) products(float* out, int iters) {
    extern __shared__ unsigned char raw[];
    unsigned char* sm = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    for (int i = threadIdx.x; i < 32768 / 4; i += blockDim.x)
        reinterpret_cast<float*>(sm)[i] = 1e-3f * (i & 7);
    usk::fence_proxy_async();
    __syncthreads();
    float acc[64];
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
    for (int it = 0; it < iters; ++it) {
        float t[64];
        usk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dh = usk::desc_sw128(sm + 32 * kk, 16, 1024);
            const uint64_t dl = usk::desc_sw128(sm + 16384 + 32 * kk, 16, 1024);
            usk::wgmma_m64n128k8_rs_tf32(t, a, dh, kk > 0);
            usk::wgmma_m64n128k8_rs_tf32(t, a, dl, 1);
            usk::wgmma_m64n128k8_rs_tf32(t, a, dh, 1);
        }
        usk::wgmma_commit();
        usk::wgmma_wait<0>();
        usk::fence_regs(t);
        for (int i = 0; i < 64; ++i) acc[i] += t[i];
    }
    float s = 0.f;
    for (int i = 0; i < 64; ++i) s += acc[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_products(int blocks, int iters, void* out, void* stream) {
    cudaFuncSetAttribute(products, cudaFuncAttributeMaxDynamicSharedMemorySize, 40000);
    products<<<blocks, 128, 40000, (cudaStream_t)stream>>>((float*)out, iters);
    return (int)cudaGetLastError();
}
'''


def _nvcc(src: pathlib.Path, lib: pathlib.Path) -> subprocess.Popen:
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-I", str(CSRC), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(source: pathlib.Path, names: List[str]) -> Dict[str, ctypes.CDLL]:
    """One library per variant of ``source``, all nvcc processes at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    procs = {}
    for name in names:
        s = text
        for old, new in VARIANTS.get(name, []):
            if old not in s:
                raise ValueError(f"variant {name}: its text is not in {source}")
            s = s.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(s)
        procs[name] = (OUT / f"lib_{name}.so", _nvcc(cu, OUT / f"lib_{name}.so"))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        libs[name].usk_conv_gelu_block_f32.argtypes = [P] * 7 + [I] * 8 + [P]
        libs[name].usk_conv_gelu_block_bwd_f32.argtypes = [P] * 12 + [I] * 9 + [P]
    return libs


def events_ms(fn, iters: int = ITERS) -> float:
    """ms per call by CUDA events around calls queued behind a sleep kernel."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_variants(libs: Dict[str, ctypes.CDLL]) -> None:
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    st = torch.cuda.current_stream().cuda_stream
    for blk, (rows, first) in BLOCKS.items():
        x = torch.randn(B, rows, C, generator=g).to(dev)
        w = (torch.randn(K, C, C, generator=g) * (2.0 / (K * C)) ** 0.5).to(dev)
        ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
              (torch.randn(B, C, generator=g) * 0.1).to(dev)) if first else None
        a, bb = (None, None) if ab is None else ab
        t_out = (rows - K) // 2 + 1
        wt = conv_stack.gemm_weight(w)
        y, pre = (torch.empty(B, t_out, C, device=dev) for _ in range(2))
        h = torch.empty(B, rows, C, device=dev) if first else None
        dy = torch.randn(B, t_out, C, generator=g).to(dev) * 1e-2
        gb, dx = torch.empty_like(dy), torch.empty_like(x)
        dw = torch.zeros(K, C, C, device=dev)
        da, db = (torch.zeros(B, C, device=dev) for _ in range(2)) if first else (None, None)
        per = conv_stack.dw_split_plan(B, t_out, C, K, sms)[0]
        py, _, ppre = conv_stack.conv_gelu_block_plain(x, w, rows, first, True, ab,
                                                       return_pre=True)
        pdx, pdw, _, _ = conv_stack.conv_gelu_block_backward_plain(x, w, rows, first, True, ab,
                                                                   dy, ppre)
        gflop = 2 * B * t_out * C * K * C / 1e9
        for name, lib in libs.items():
            fwd = lambda: lib.usk_conv_gelu_block_f32(  # noqa: E731
                x.data_ptr(), wt.data_ptr(), ptr(a), ptr(bb), ptr(h), y.data_ptr(),
                pre.data_ptr(), B, rows, rows, t_out, C, K, int(first), 1, st)
            bwd = lambda parts: lib.usk_conv_gelu_block_bwd_f32(  # noqa: E731
                x.data_ptr(), w.data_ptr(), ptr(a), ptr(bb), dy.data_ptr(), ppre.data_ptr(),
                ptr(gb), ptr(h), dx.data_ptr(), dw.data_ptr(), ptr(da), ptr(db), B, rows, rows,
                t_out, C, K, int(first), parts, per, st)
            if fwd() or bwd(3):
                raise RuntimeError(f"{name}: launch failed")
            dw.zero_()
            bwd(3)
            torch.cuda.synchronize()
            errs = f"y {rel(y, py):.2e} dx {rel(dx, pdx):.2e} dw {rel(dw, pdw):.2e}"
            passes = events_ms(lambda: bwd(0))
            f_ms = events_ms(fwd)
            dx_ms = events_ms(lambda: bwd(1)) - passes
            dw_ms = events_ms(lambda: bwd(2)) - passes
            print(f"{blk} {name:13s} fwd_ms={f_ms:.4f} dx_ms={dx_ms:.4f} dw_ms={dw_ms:.4f} "
                  f"tf32_tflops fwd={3 * gflop / f_ms:.0f} dx={3 * gflop / dx_ms:.0f} "
                  f"dw={3 * gflop / dw_ms:.0f} rel_l2 {errs}", flush=True)


def time_products() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib_path = OUT / "products.cu", OUT / "lib_products.so"
    cu.write_text(PRODUCTS_CU)
    p = _nvcc(cu, lib_path)
    log, _ = p.communicate()
    if p.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    lib.run_products.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 3 * 128, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    iters = 2000
    for per_sm in (1, 2, 3):
        run = lambda: lib.run_products(sms * per_sm, iters, out.data_ptr(), st)  # noqa: E731
        ms = events_ms(run, 1)
        flops = sms * per_sm * iters * 12 * 2 * 64 * 128 * 8
        print(f"products warpgroups_per_sm={per_sm} tf32_tflops={flops / ms / 1e9:.0f}",
              flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("variants", nargs="*", help=f"of {sorted(VARIANTS)} (default: all)")
    p.add_argument("--source", type=pathlib.Path, default=CSRC / "conv_stack_f32.cu")
    p.add_argument("--products", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_conv_f32_variants needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    if args.products:
        time_products()
        return
    time_variants(build(args.source, ["as_is"] + (args.variants or sorted(VARIANTS))))


if __name__ == "__main__":
    sys.exit(main())
