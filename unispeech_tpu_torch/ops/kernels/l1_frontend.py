"""First conv layer of the waveform frontend fused with its GroupNorm stats.

Counterpart of the JAX package's ``ops/pallas/l1_frontend.py``: one pass
from the raw waveform writes the (B, t1, C) conv output and the per-(batch,
channel) fp32 sum and sum of squares of its bf16-rounded values, so the
GroupNorm mean/variance need no second pass over the largest tensor of the
model. CUDA tensors go to the kernel in ``csrc/l1_frontend.cu``; CPU tensors
to the plain version below.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches made by l1_conv_with_stats

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def check_geometry(kernel_size: int, stride: int) -> None:
    """The fused layer takes a window of one or two stride rows."""
    if not (stride <= kernel_size <= 2 * stride and stride <= 8):
        raise ValueError(
            f"fused L1 needs stride <= k <= 2*stride and stride <= 8, "
            f"got k={kernel_size}, stride={stride}")


def l1_conv_with_stats_plain(wav, kernel, stride: int, dtype=torch.bfloat16):
    """Plain version: conv1d of the dtype-rounded waveform with the
    dtype-rounded (k, 1, C) kernel, fp32 accumulation, output rounded to
    dtype; fp32 sums over time of the rounded output and its square."""
    k, cin, C = kernel.shape
    check_geometry(k, stride)
    x = wav.to(dtype).float()[:, None, :]
    w = kernel.to(dtype).float().permute(2, 1, 0)  # (C, 1, k)
    y = F.conv1d(x, w, stride=stride).transpose(1, 2).to(dtype).contiguous()
    yf = y.float()
    return y, yf.sum(1), (yf * yf).sum(1), y.shape[1]


def l1_conv_with_stats(wav: torch.Tensor, kernel: torch.Tensor, stride: int,
                       dtype=torch.bfloat16):
    """Fused first-layer conv + GroupNorm statistics.

    wav (B, NS) waveform; kernel (k, 1, C) in the JAX (k, in, out) layout
    with stride <= k <= 2*stride. Returns (y1, s1, s2, t1): y1 (B, t1, C) in
    ``dtype`` with exactly t1 = (NS - k)//stride + 1 rows, s1/s2 (B, C) fp32
    sums of y1 and y1**2 over time. CPU tensors take the plain version; a
    CUDA tensor launches the kernel (bf16 only) or raises.
    """
    global launches
    if not wav.is_cuda:
        return l1_conv_with_stats_plain(wav, kernel, stride, dtype)
    k, cin, C = kernel.shape
    check_geometry(k, stride)
    req = _build.require
    req(dtype == torch.bfloat16, f"L1 kernel computes in bf16, not {dtype}")
    req(wav.dtype == torch.float32 and wav.dim() == 2 and wav.is_contiguous(),
        "L1 kernel takes a contiguous (B, NS) fp32 waveform")
    req(kernel.device == wav.device, "kernel and waveform on different devices")
    req(cin == 1 and C % 64 == 0 and C <= 2048,
        f"L1 kernel takes (k, 1, C) with C % 64 == 0, C <= 2048, got {tuple(kernel.shape)}")
    B, NS = wav.shape
    t1 = (NS - k) // stride + 1
    req(t1 >= 1 and B >= 1, f"waveform of {NS} samples is shorter than one window")
    w = kernel[:, 0, :].to(torch.bfloat16).contiguous()
    y = torch.empty((B, t1, C), dtype=torch.bfloat16, device=wav.device)
    s1 = torch.zeros((B, C), dtype=torch.float32, device=wav.device)
    s2 = torch.zeros((B, C), dtype=torch.float32, device=wav.device)
    fn = _build.function("usk_l1_conv_stats", _SIGNATURE)
    _build.launch(fn, "l1_conv_with_stats", wav.device, wav.data_ptr(), w.data_ptr(),
                  y.data_ptr(), s1.data_ptr(), s2.data_ptr(), B, NS, t1, C, k, stride,
                  _build.stream(wav))
    launches += 1
    return y, s1, s2, t1
