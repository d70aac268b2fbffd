"""First conv layer of the waveform frontend fused with its GroupNorm stats.

Counterpart of the JAX package's ``ops/pallas/l1_frontend.py``: one pass
from the raw waveform writes the (B, t1, C) conv output and the per-(batch,
channel) fp32 sum and sum of squares of its bf16-rounded values, so the
GroupNorm mean/variance need no second pass over the largest tensor of the
model; ``with_stats=False`` (the ``layer_norm`` extractor) writes y1 alone.
CUDA tensors go to the kernels in ``csrc/l1_frontend.cu`` (both directions
one launch, y1 computed on tensor cores from the JAX kernel's collapsed
waveform layout by persistent blocks; the forward writes y1 with streaming
stores, the backward reads dy by TMA); CPU tensors to the plain versions
below. ``dtype`` is bf16 or fp32 (the models' default): fp32 launches the
fp32 kernels of ``csrc/l1_frontend_f32.cu`` in both directions (CUDA-core
FMAs, nothing rounded). The fp32 backward is bound by its read of dy: one
persistent block per SM walks (utterance, R-row) tiles, a producer thread
brings each tile's dy (one bulk copy) and samples (TMA boxes) into an
mbarrier ring, and eight consumer warps keep the dW partial sums in
registers until one reduction per block; ``bwd_f32_plan`` gives its tiles,
ring and grid, which the CPU tests hold.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from unispeech_tpu_torch.ops.fp32_conv import conv1d
from unispeech_tpu_torch.ops.kernels import _build

launches = 0  # forward kernel launches made by l1_conv_with_stats (bf16 and fp32)
backward_launches = 0  # backward kernel launches made by l1_conv_backward

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_BWD_SIGNATURE = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_BWD_F32_SIGNATURE = _BWD_SIGNATURE[:-1] + [_I, _I, _I, _I, _P]

# the fp32 backward kernel's constants (csrc/l1_frontend_f32.cu)
BWD_F32_WARPS = 8  # consumer warps; a thread owns 4 channels
BWD_F32_ROWS = 8  # consecutive rows of a thread per tile
BWD_F32_STAGES = 4  # ring stages at most
BWD_F32_X_BOX = 128  # fp32 samples per TMA box of the waveform
SMEM_BLOCK_MAX = 232_448  # dynamic shared memory a block may take (227 KB)
SMEM_SM = 233_472  # shared memory of an SM, 1 KB of it reserved per block


class BwdF32Plan(NamedTuple):
    """The fp32 backward kernel's launch: tiles of ``rows`` rows of one
    utterance (``tiles_per_b`` per utterance), each a ring stage of
    ``stage_bytes`` (its dy, then ``x_boxes`` boxes of samples), ``stages``
    of them, ``smem`` bytes with the barriers and the 1024-byte alignment,
    ``grid`` persistent blocks."""
    rows: int
    x_boxes: int
    stage_bytes: int
    stages: int
    smem: int
    tiles_per_b: int
    grid: int


def bwd_f32_plan(B: int, t1: int, C: int, k: int, stride: int, sms: int) -> BwdF32Plan:
    """The fp32 L1 backward's tiles, ring and grid for ``sms`` SMs. The
    256 consumer threads own 4 channels each: C / 4 threads per row lane,
    as many row lanes as fit, each BWD_F32_ROWS consecutive rows of a tile,
    so R = BWD_F32_ROWS x 1024 // C rows (~32 KB of dy). A stage's samples
    start at the 16-byte boundary at or before the tile's first (up to 3
    more). As many stages as fit, at most four (six read no faster); one
    block per SM (the ring takes over half of its shared memory), never
    more blocks than tiles."""
    lanes = 32 * BWD_F32_WARPS // (C // 4)
    rows = lanes * BWD_F32_ROWS
    x_boxes = -(-(stride * rows + k - stride + 3) // BWD_F32_X_BOX)
    stage_bytes = -(-(rows * C * 4 + x_boxes * BWD_F32_X_BOX * 4) // 1024) * 1024
    stages = min(BWD_F32_STAGES, (SMEM_BLOCK_MAX - 1024) // (stage_bytes + 16))
    smem = stages * stage_bytes + 16 * stages + 1024
    tiles_per_b = -(-t1 // rows)
    resident = SMEM_SM // (smem + 1024)
    return BwdF32Plan(rows, x_boxes, stage_bytes, stages, smem, tiles_per_b,
                      min(B * tiles_per_b, sms * resident))


def check_geometry(kernel_size: int, stride: int) -> None:
    """The fused layer takes a window of one or two stride rows."""
    if not (stride <= kernel_size <= 2 * stride and stride <= 8):
        raise ValueError(
            f"fused L1 needs stride <= k <= 2*stride and stride <= 8, "
            f"got k={kernel_size}, stride={stride}")


def l1_conv_with_stats_plain(wav, kernel, stride: int, dtype=torch.bfloat16,
                             with_stats: bool = True):
    """Plain version: conv1d of the dtype-rounded waveform with the
    dtype-rounded (k, 1, C) kernel, fp32 accumulation, output rounded to
    dtype; fp32 sums over time of the rounded output and its square (None
    without ``with_stats``)."""
    k, cin, C = kernel.shape
    check_geometry(k, stride)
    x = wav.to(dtype).float()[:, None, :]
    w = kernel.to(dtype).float().permute(2, 1, 0)  # (C, 1, k)
    y = conv1d(x, w, stride=stride).transpose(1, 2).to(dtype).contiguous()
    if not with_stats:
        return y, None, None, y.shape[1]
    yf = y.float()
    return y, yf.sum(1), (yf * yf).sum(1), y.shape[1]


def l1_conv_backward_plain(wav, kernel, stride: int, dy, ds1=None, ds2=None,
                           dtype=torch.bfloat16):
    """Plain version of the weight gradient, in the kernel's arithmetic:
    dy1 = dy + ds1 + 2*ds2*y1 (y1 the recomputed dtype-rounded output) in
    fp32, rounded to dtype, then dW[j, c] = sum over (b, t < t1) of
    x[b, t*stride + j] * dy1[b, t, c] in fp32. Returns (k, 1, C) fp32."""
    k, _, C = kernel.shape
    t1 = dy.shape[1]
    x = wav.to(dtype).float()
    d = dy.float()
    if ds1 is not None:
        d = d + ds1.float()[:, None, :]
    if ds2 is not None:
        y1 = l1_conv_with_stats_plain(wav, kernel, stride, dtype)[0].float()
        d = d + 2.0 * ds2.float()[:, None, :] * y1
    d = d.to(dtype).float()
    windows = x.unfold(1, k, stride)[:, :t1]  # (B, t1, k)
    return torch.einsum("btj,btc->jc", windows, d)[:, None, :]


def _geometry_cuda(wav, kernel, stride, dtype):
    """Raise for inputs the kernels do not take; returns the geometry and
    the (k, C) weights in ``dtype``."""
    k, cin, C = kernel.shape
    check_geometry(k, stride)
    req = _build.require
    req(dtype in _build.COMPUTE_DTYPES, f"L1 kernels compute in bf16 or fp32, not {dtype}")
    req(wav.dtype == torch.float32 and wav.dim() == 2 and wav.is_contiguous(),
        "L1 kernel takes a contiguous (B, NS) fp32 waveform")
    req(kernel.dtype in (torch.float32, dtype),
        f"L1 kernel's weights must be fp32 or {dtype}, got {kernel.dtype}")
    req(kernel.device == wav.device, "kernel and waveform on different devices")
    req(cin == 1 and C % 64 == 0 and C <= 2048,
        f"L1 kernel takes (k, 1, C) with C % 64 == 0, C <= 2048, got {tuple(kernel.shape)}")
    B, NS = wav.shape
    t1 = (NS - k) // stride + 1
    req(t1 >= 1 and B >= 1, f"waveform of {NS} samples is shorter than one window")
    req(B * NS < 2**31, f"L1 kernels index {B} x {NS} samples with 32-bit integers")
    w = kernel[:, 0, :].to(dtype).contiguous()
    # the fp32 kernel reads its taps as float4
    return B, NS, t1, k, C, w.clone() if w.data_ptr() % 16 else w


def _forward(wav, kernel, stride, dtype, with_stats):
    global launches
    if not wav.is_cuda:
        return l1_conv_with_stats_plain(wav, kernel, stride, dtype, with_stats)
    B, NS, t1, k, C, w = _geometry_cuda(wav, kernel, stride, dtype)
    y = torch.empty((B, t1, C), dtype=dtype, device=wav.device)
    s1 = s2 = None
    if with_stats:
        s1 = torch.zeros((B, C), dtype=torch.float32, device=wav.device)
        s2 = torch.zeros((B, C), dtype=torch.float32, device=wav.device)
    entry = "usk_l1_conv_fwd_f32" if dtype == torch.float32 else "usk_l1_conv_fwd"
    fn = _build.function(entry, _SIGNATURE)
    _build.launch(fn, "l1_conv_with_stats", wav.device, wav.data_ptr(), w.data_ptr(),
                  y.data_ptr(), None if s1 is None else s1.data_ptr(),
                  None if s2 is None else s2.data_ptr(), B, NS, t1, C, k, stride,
                  _build.stream(wav))
    launches += 1
    return y, s1, s2, t1


def _check_backward(wav, kernel, stride, dy, dtype):
    """Raise for a backward the kernels do not take (dy in ``dtype``, the
    forward's output shape); returns the forward's geometry and weights."""
    B, NS, t1, k, C, w = _geometry_cuda(wav, kernel, stride, dtype)
    req = _build.require
    req(C <= 1024, f"L1 backward kernel takes C <= 1024 channels, got {C}")
    req(dy.dtype == dtype and dy.shape == (B, t1, C) and dy.device == wav.device,
        f"dy must be {dtype} ({B}, {t1}, {C}) on the waveform's device, got {dy.dtype} "
        f"{tuple(dy.shape)}")
    return B, NS, t1, k, C, w


def l1_conv_backward(wav, kernel, stride: int, dy, ds1=None, ds2=None,
                     dtype=torch.bfloat16):
    """The weight gradient of ``l1_conv_with_stats`` from the cotangents of
    y1 (B, t1, C) and of the sums (B, C) (None: no such term). CPU tensors
    take the plain version; a CUDA tensor launches the kernel (bf16 or fp32
    ``dtype``, dy in it) or raises. Returns (k, 1, C) fp32."""
    global backward_launches
    if not wav.is_cuda:
        return l1_conv_backward_plain(wav, kernel, stride, dy, ds1, ds2, dtype)
    B, NS, t1, k, C, w = _check_backward(wav, kernel, stride, dy, dtype)
    req = _build.require
    dy = dy.contiguous()
    # both kernels read dy and the waveform by bulk copies or TMA, the fp32
    # one the taps and the sums as float4: 16-byte aligned
    dy = dy.clone() if dy.data_ptr() % 16 else dy
    wav = wav.clone() if wav.data_ptr() % 16 else wav
    sums = []
    for name, t in (("ds1", ds1), ("ds2", ds2)):
        if t is not None:
            t = t.to(torch.float32).contiguous()
            t = t.clone() if t.data_ptr() % 16 else t
            req(t.shape == (B, C) and t.device == wav.device, f"{name} must be ({B}, {C})")
        sums.append(t)
    dw = torch.zeros((k, C), dtype=torch.float32, device=wav.device)
    if dtype == torch.float32:
        fn = _build.function("usk_l1_conv_bwd_f32", _BWD_F32_SIGNATURE)
        sms = torch.cuda.get_device_properties(wav.device).multi_processor_count
        plan = bwd_f32_plan(B, t1, C, k, stride, sms)
        extra = (plan.rows, plan.stages, plan.grid, plan.smem)
    else:
        fn = _build.function("usk_l1_conv_bwd", _BWD_SIGNATURE)
        extra = ()
    _build.launch(fn, "l1_conv_backward", wav.device, wav.data_ptr(), w.data_ptr(),
                  dy.data_ptr(), None if sums[0] is None else sums[0].data_ptr(),
                  None if sums[1] is None else sums[1].data_ptr(), dw.data_ptr(),
                  B, NS, t1, C, k, stride, *extra, _build.stream(wav))
    backward_launches += 1
    return dw[:, None, :]


class _L1WithStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wav, kernel, stride, dtype, with_stats):
        y, s1, s2, t1 = _forward(wav, kernel, stride, dtype, with_stats)
        ctx.stride, ctx.dtype = stride, dtype
        ctx.save_for_backward(wav, kernel)
        return (y, s1, s2) if with_stats else y

    @staticmethod
    def backward(ctx, dy, ds1=None, ds2=None):
        wav, kernel = ctx.saved_tensors
        dw = l1_conv_backward(wav, kernel, ctx.stride, dy.to(ctx.dtype), ds1, ds2, ctx.dtype)
        dwav = torch.zeros_like(wav) if ctx.needs_input_grad[0] else None
        return dwav, dw.to(kernel.dtype), None, None, None


def l1_conv_with_stats(wav: torch.Tensor, kernel: torch.Tensor, stride: int,
                       dtype=torch.bfloat16, with_stats: bool = True):
    """Fused first-layer conv + GroupNorm statistics.

    wav (B, NS) waveform; kernel (k, 1, C) in the JAX (k, in, out) layout
    with stride <= k <= 2*stride. Returns (y1, s1, s2, t1): y1 (B, t1, C) in
    ``dtype`` with exactly t1 = (NS - k)//stride + 1 rows, s1/s2 (B, C) fp32
    sums of y1 and y1**2 over time, both None without ``with_stats`` (the
    kernel then writes y1 alone). Differentiable in ``kernel``. CPU tensors
    take the plain versions; a CUDA tensor launches the kernels (bf16 or
    fp32 ``dtype``) or raises.
    """
    if torch.is_grad_enabled() and kernel.requires_grad:
        out = _L1WithStats.apply(wav, kernel, stride, dtype, with_stats)
        y, s1, s2 = out if with_stats else (out, None, None)
        return y, s1, s2, y.shape[1]
    return _forward(wav, kernel, stride, dtype, with_stats)
