"""Time the attention forward kernel on the card at the serving and the
pretraining shapes, or at HuBERT X-Large's or XLS-R 2B's.

    python -m unispeech_tpu_torch.scripts.bench_attention_forward [--shape xlarge|xlsr2b] [--dtype fp32] [--variants]

One call of ``fused_attention`` as WavLM-Base+ serving makes it (4
utterances padded to 799 frames, 12 heads of 64, the gated relative-position
bias, key padding) and one as WavLM-Base pretraining makes it (6 crops of 768
frames, attention dropout 0.1). ``--shape xlarge``: as HuBERT X-Large makes
it on the padded smoke batch (4 rows of 799 frames, 799/599/349/149 valid,
16 heads of 80, key padding, no bias), without dropout (the eval forward)
and with dropout 0.1 (fine-tuning). ``--shape xlsr2b``: the same at XLS-R
2B's 16 heads of 120. For each it prints ms per call by CUDA
events around calls queued behind a busy card, the device time of the
kernel alone under ``torch.profiler`` (every kernel whose name holds
``flash_fwd_f32`` in fp32: the width-64 kernel, the width-80 / width-96
``flash_fwd_f32_mid_kernel`` and the width-128
``flash_fwd_f32_wide_kernel``), the largest error
against the plain version (relative to its largest value; in fp32 also the
relative L2 distance), the bound (the bytes of q, k, v, out and the bias at
3.35 TB/s, or 4 H T keys hd operations over the valid keys, in fp32 three
TF32 products each, at the tensor cores' peak, whichever is longer) and
the same forward by one PyTorch call as a yardstick (``sdpa_ms``:
``F.scaled_dot_product_attention`` with the same mask and bias and the
dropout rate, its own dropout draws), by CUDA events as above.
``--dtype fp32``: the same in fp32, the models' default dtype (the fp32
kernels, ``csrc/flash_attention_f32.cu`` and, at hd 72-96,
``csrc/flash_attention_f32_mid.cu``, at hd 104-128
``csrc/flash_attention_f32_wide.cu``; ``width=`` says which width ran).
``--variants`` (with ``--dtype fp32`` and ``--shape xlarge`` or
``xlsr2b``): builds copies of the fp32 forward's sources with one piece of
the width-80 form (``VARIANTS``: one warpgroup per block, every key tile
run, one wait per k step of S) or of the width-128 form
(``WIDE_VARIANTS``: every key tile run, one wait per k step of S)
changed each into the gitignored
``archive_check/attn_fwd_f32_variants/``, nvcc all at once (~1 min), and
times a call through each one's entry in both cases as ``call_ms`` above
(the wrapper's work included), with its relative L2 distance to the plain
version.
Inputs come from seed 0, so two builds of the kernel can be compared in one
run on one card (run the module from each copy of the package). Needs a
CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import pathlib
import subprocess
from typing import Dict, List, Tuple
from unittest import mock

import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.kernels import (
    BF16_TC_FLOPS,
    HBM_BYTES_PER_S,
    TF32_TC_FLOPS,
    _build,
    flash_attention,
)
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias
from unispeech_tpu_torch.scripts.bench_attention_backward import (
    DTYPES,
    SHAPES,
    kernel_ms,
    queued_ms,
)

ITERS = 50
NUM_BUCKETS, MAX_DISTANCE = 320, 800
# case: (B, T, H, head dim, valid frames per row or None, dropout rate, gated bias)
CASES = {
    "default": {"serving": (4, 799, 12, 64, (799, 599, 399, 199), 0.0, True),
                "train_dropout": (6, 768, 12, 64, None, 0.1, True)},
    "xlarge": {"xlarge": (*SHAPES["xlarge"], 0.0, False),
               "xlarge_dropout": (*SHAPES["xlarge"], 0.1, False)},
    "xlsr2b": {"xlsr2b": (*SHAPES["xlsr2b"], 0.0, False),
               "xlsr2b_dropout": (*SHAPES["xlsr2b"], 0.1, False)},
}


# gitignored, in the checkout
VARIANT_DIR = _build.PACKAGE_DIR.parent / "archive_check" / "attn_fwd_f32_variants"
# the fp32 forward's translation units: the entry and width 64, widths 80 /
# 96, width 128
F32_SOURCES = ("flash_attention_f32.cu", "flash_attention_f32_mid.cu",
               "flash_attention_f32_wide.cu")
MID_SOURCE, WIDE_SOURCE = F32_SOURCES[1:]
# name -> [(text, replacement)] in csrc/flash_attention_f32_mid.cu
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "one_warpgroup": [("constexpr int kWG80 = 2; ", "constexpr int kWG80 = 1; ")],
    "every_tile": [("    const bool masked = a.kpm != nullptr && a.amask == nullptr;",
                    "    const bool masked = false;")],
    # one wait per k step of S in place of two accumulators in turn
    "serial_s": [("                usk::wgmma_wait<1>();  // step kk - 1's products",
                  "                usk::wgmma_wait<0>();")],
}
# name -> [(text, replacement)] in csrc/flash_attention_f32_wide.cu
WIDE_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "every_tile": [("    const bool masked = a.kpm != nullptr && a.amask == nullptr;",
                    "    const bool masked = false;")],
    # one wait per k step of S in place of two accumulators in turn
    "serial_s": [("                usk::wgmma_wait<1>();  // step kk - 1's products",
                  "                usk::wgmma_wait<0>();")],
}


def build_variants(out: pathlib.Path, names: List[str], source: str = MID_SOURCE,
                   variants: Dict[str, List[Tuple[str, str]]] = VARIANTS
                   ) -> Dict[str, ctypes.CDLL]:
    """One library per variant (the fp32 forward's translation units, with
    ``source`` changed as ``variants`` says), nvcc all at once."""
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / source).read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in variants.get(name, []):
            if old not in src:
                raise ValueError(f"variant {name}: its text is not in {source}")
            src = src.replace(old, new)
        cu, lib = out / f"{name}_{source}", out / f"lib_{name}.so"
        cu.write_text(src)
        units = [cu if f == source else _build.CSRC_DIR / f for f in F32_SOURCES]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
               "-o", str(lib), *(str(u) for u in units)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        (out / f"{name}.log").write_text(log)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@contextlib.contextmanager
def entry_of(lib: ctypes.CDLL):
    """fused_attention with its fp32 entry taken from ``lib``."""
    fn = lib.usk_flash_attention_fwd_f32
    fn.argtypes = flash_attention._FWD_SIGNATURE
    fn.restype = ctypes.c_int
    with mock.patch.object(_build, "function", lambda name, argtypes: fn):
        yield


def bound_ms(B, T, H, hd, valid, esz: int, bias: bool) -> float:
    """The least time of one forward call: bytes or operations."""
    keys = sum(valid) if valid is not None else B * T
    nbytes = 4 * B * T * H * hd * esz + (H * T * T * esz if bias else 0)
    mult, peak = (3, TF32_TC_FLOPS) if esz == 4 else (1, BF16_TC_FLOPS)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, mult * 4 * H * T * keys * hd / peak)


def library_forward(q, k, v, kw):
    """A closure computing the same forward by SDPA: the mask is the gated
    bias plus the key padding, or a boolean key mask without bias."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    kpm, rate = kw.get("key_padding_mask"), kw.get("dropout_rate", 0.0)
    if "bias" in kw:
        mask = kw["gate"][..., None] * kw["bias"].float()[None]
        if kpm is not None:
            mask = mask + torch.where(kpm, -1e30, 0.0)[:, None, None, :]
        mask = mask.to(q.dtype)
    else:
        mask = None if kpm is None else ~kpm[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, dropout_p=rate)


def main(argv=None) -> Dict[str, float]:
    """Times the shape's cases and prints one line each; returns the
    kernel's device ms per call by case."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--shape", choices=sorted(CASES), default="default")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--variants", action="store_true",
                   help="with --dtype fp32: time the width-80 form's variants (--shape "
                        "xlarge) or the width-128 form's (--shape xlsr2b)")
    args = p.parse_args(argv)
    forms = {"xlarge": (MID_SOURCE, VARIANTS), "xlsr2b": (WIDE_SOURCE, WIDE_VARIANTS)}
    if args.variants and (args.shape not in forms or args.dtype != "fp32"):
        p.error("--variants times an fp32 form: --shape xlarge or xlsr2b, --dtype fp32")
    dt = DTYPES[args.dtype]
    f32 = dt == torch.float32
    kernel = "flash_fwd_f32" if f32 else "flash_fwd_kernel"
    if not torch.cuda.is_available():
        raise RuntimeError("bench_attention_forward needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    card = torch.cuda.get_device_name(dev).replace(" ", "_")
    res = {}
    libs = {}
    if args.variants:
        source, table = forms[args.shape]
        libs = build_variants(VARIANT_DIR, ["as_is", *table], source, table)
    for case, (B, T, H, hd, valid, rate, with_bias) in CASES[args.shape].items():
        q, k, v = (torch.randn(B, T, H, hd, generator=g).to(dev, dt) for _ in range(3))
        kw = {}
        if with_bias:
            table = (torch.randn(NUM_BUCKETS, H, generator=g) * 0.5).to(dev)
            kw.update(bias=compute_rel_pos_bias(table, T, T, NUM_BUCKETS, MAX_DISTANCE, dtype=dt),
                      gate=(torch.rand(B, H, T, generator=g) * 2 + 1).to(dev))
        if valid is not None:
            frames = torch.tensor(valid, device=dev)
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
        sdpa = queued_ms(library_forward(q, k, v, kw), ITERS)
        # a copy of the package from before f32_width prints n/a
        width_of = getattr(flash_attention, "f32_width", lambda _: "n/a")
        width = f" width={width_of(hd)}" if f32 else ""
        print(f"{case:14s} {args.dtype} call_ms={call:.4f} {kernel}_ms={kern:.4f} err={err:.2e} "
              f"rel_l2={rel:.2e} bound_ms={bound_ms(B, T, H, hd, valid, dt.itemsize, with_bias):.4f}"
              f" sdpa_ms={sdpa:.4f}{width} {card}", flush=True)
        res[case] = kern
        for name, lib in libs.items():
            with entry_of(lib):
                vrel = float((fn().float() - want).norm() / want.norm())
                ms = queued_ms(fn, ITERS)
            print(f"variant {name:13s} {case:14s} call_ms={ms:.4f} rel_l2={vrel:.2e} {card}",
                  flush=True)
    return res


if __name__ == "__main__":
    main()
