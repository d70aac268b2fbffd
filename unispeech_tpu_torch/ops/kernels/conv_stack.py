"""Fused strided-conv1d + GELU blocks of the waveform frontend.

Counterpart of the JAX package's ``ops/pallas/conv_stack.py`` (forward):
one block computes y = gelu?(conv_{k in {2,3}, s=2}(gelu_in?(x*a + b))),
where (a, b) is the frontend GroupNorm folded in as a per-(batch, channel)
affine. GELU is exact erf (the TPU kernel's polynomial exists only because
Mosaic has no erf). CUDA tensors go to the kernel in ``csrc/conv_stack.cu``;
CPU tensors to the plain version below.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches made by conv_gelu_block

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]

Affine = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _check(kernel: torch.Tensor, valid_len: int, ts: int) -> int:
    k, cin, cout = kernel.shape
    if k not in (2, 3) or cin != cout:
        raise ValueError(
            f"conv block takes a (k, C, C) kernel with k in (2, 3), got {tuple(kernel.shape)}")
    if not k <= valid_len <= ts:
        raise ValueError(f"valid_len {valid_len} outside [{k}, {ts}]")
    return (valid_len - k) // 2 + 1


def conv_gelu_block_plain(x, kernel, valid_len: int, gelu_in: bool = False,
                          gelu_out: bool = True, affine: Affine = None):
    """Plain version: the same roundings as the kernel, the conv by
    F.conv1d in fp32 on the dtype-rounded operands."""
    t_out = _check(kernel, valid_len, x.shape[1])
    h = x[:, :valid_len]
    if affine is not None:
        a, b = affine
        h = (h.float() * a.float()[:, None, :] + b.float()[:, None, :]).to(x.dtype)
    if gelu_in:
        h = F.gelu(h.float()).to(x.dtype)
    w = kernel.to(x.dtype).float().permute(2, 1, 0)  # (C_out, C_in, k)
    y = F.conv1d(h.float().transpose(1, 2), w, stride=2).transpose(1, 2)
    if gelu_out:
        y = F.gelu(y)
    return y.to(x.dtype).contiguous(), t_out


def conv_gelu_block(x: torch.Tensor, kernel: torch.Tensor, valid_len: int,
                    gelu_in: bool = False, gelu_out: bool = True,
                    affine: Affine = None):
    """One fused frontend stage on x (B, T, C), the first ``valid_len`` rows
    valid; kernel (k, C, C) in the JAX (k, in, out) layout, stride 2.
    ``affine`` ((B, C), (B, C)) fp32 applies x*a + b before gelu_in.
    Returns (y, t_out) with y (B, t_out, C), t_out = (valid_len - k)//2 + 1.
    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (bf16, C % 128 == 0) or raises."""
    global launches
    if not x.is_cuda:
        return conv_gelu_block_plain(x, kernel, valid_len, gelu_in, gelu_out, affine)
    B, ts, C = x.shape
    t_out = _check(kernel, valid_len, ts)
    k = kernel.shape[0]
    req = _build.require
    req(x.dtype == torch.bfloat16 and x.is_contiguous(),
        "conv block kernel takes a contiguous bf16 (B, T, C) input")
    req(kernel.shape[1] == C and C % 128 == 0,
        f"conv block kernel takes C % 128 == 0 channels matching x, got {C}")
    req(kernel.device == x.device, "kernel and input on different devices")
    w = kernel.to(torch.bfloat16).contiguous()
    a_ptr = b_ptr = None
    if affine is not None:
        a, b = (t.to(torch.float32).contiguous() for t in affine)
        req(a.shape == (B, C) and b.shape == (B, C) and a.device == x.device
            and b.device == x.device, "affine must be two (B, C) tensors on x's device")
        a_ptr, b_ptr = a.data_ptr(), b.data_ptr()
    y = torch.empty((B, t_out, C), dtype=torch.bfloat16, device=x.device)
    fn = _build.function("usk_conv_gelu_block", _SIGNATURE)
    _build.launch(fn, "conv_gelu_block", x.device, x.data_ptr(), w.data_ptr(), a_ptr,
                  b_ptr, y.data_ptr(), B, ts, t_out, C, k, int(gelu_in), int(gelu_out),
                  _build.stream(x))
    launches += 1
    return y, t_out
