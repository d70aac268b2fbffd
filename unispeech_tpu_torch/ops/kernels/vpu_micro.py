"""Elementwise micro-benchmark: one pass y = bf16(fn(fp32(x))) for seven fn.

Counterpart of the JAX package's ``scripts/exp_vpu_micro.py::run`` (a
Pallas pass over (1, 512, C) blocks, written to calibrate the cost of the
conv chain's elementwise work). The seven functions, fp32 inside and bf16
out, in the TPU script's operation order:

  copy          x
  exp           exp(x)
  gelu_poly8    conv_stack.py gelu_poly: clamp to +-4, odd degree-8
                polynomial _EC in s = x^2
  gelu_poly6c   the script's gelu_p6: clamp to +-4, _EC6
  gelu_AS_exp   the script's gelu_as: Abramowitz-Stegun erf with exp, sign
  dgelu_poly8   conv_stack.py dgelu_poly: 0.5 + x * _DC(x^2)
  gelu+dgelu6   gelu_poly6c(x) + dgelu_poly8(x)

CUDA tensors go to ``csrc/vpu_micro.cu`` (bound: bytes, 4 bytes moved per
element; design: two 16-byte streaming loads in flight per thread, one
block per 512 vectors; gelu+dgelu6 through a ring of bulk copies in shared
memory); CPU tensors to the plain versions below, one fp32 operation per
step, as the kernel rounds.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from unispeech_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches made by run

# unispeech_tpu/ops/pallas/conv_stack.py _EC, _DC; scripts/exp_vpu_micro.py _EC6
_EC = (0.7978798369829468, -0.1329281632415494, 0.019851365933651353,
       -0.002306613008596877, 0.0002060473874672504, -1.3578203070120535e-05,
       6.106341836551969e-07, -1.644168708633473e-08, 1.974271700341295e-10)
_DC = (0.7978502576382046, -0.2655808761287283, 0.059138551331160055,
       -0.008991662822732652, 0.0009659534590119215, -7.201324920337509e-05,
       3.5106104941003603e-06, -9.964039664251937e-08, 1.2392112474887641e-09)
_EC6 = (0.7977546527455531, -0.13207268166258174, 0.01890029464874129,
        -0.0019069132507172663, 0.00012426883332851077, -4.593486471180218e-06,
        7.213958366766196e-08)


def _poly_s(coefs, s: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(s, coefs[-1])
    for c in coefs[-2::-1]:
        acc = acc * s + c
    return acc


def _gelu_poly8(x):
    xc = x.clamp(-4.0, 4.0)
    return 0.5 * x * (1.0 + xc * _poly_s(_EC, xc * xc))


def _gelu_poly6c(x):
    t = x.clamp(-4.0, 4.0)
    return 0.5 * x * (1.0 + t * _poly_s(_EC6, t * t))


def _dgelu_poly8(x):
    xc = x.clamp(-4.0, 4.0)
    return 0.5 + xc * _poly_s(_DC, xc * xc)


def _gelu_as_exp(x):
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    z = x * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    e = torch.sign(z) * (1.0 - poly * torch.exp(-az * az))
    return 0.5 * x * (1.0 + e)


# name -> fp32 function; the order is the C entry's variant number
VARIANTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "copy": lambda x: x,
    "exp": torch.exp,
    "gelu_poly8": _gelu_poly8,
    "gelu_poly6c": _gelu_poly6c,
    "gelu_AS_exp": _gelu_as_exp,
    "dgelu_poly8": _dgelu_poly8,
    "gelu+dgelu6": lambda x: _gelu_poly6c(x) + _dgelu_poly8(x),
}
_INDEX = {name: i for i, name in enumerate(VARIANTS)}
_SIGNATURE = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def run_plain(variant: str, x: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: fp32 inside, x's dtype out."""
    return VARIANTS[variant](x.float()).to(x.dtype)


def run(variant: str, x: torch.Tensor) -> torch.Tensor:
    """One elementwise pass of ``variant`` over x. CPU tensors take the plain
    version; a CUDA tensor launches the kernel (contiguous bf16) or raises."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {sorted(VARIANTS)}")
    if not x.is_cuda:
        return run_plain(variant, x)
    _build.require(x.dtype == torch.bfloat16 and x.is_contiguous() and x.data_ptr() % 16 == 0,
                   "the micro-benchmark kernel takes a contiguous, 16-byte aligned bf16 tensor")
    y = torch.empty_like(x)
    fn = _build.function("usk_vpu_micro", _SIGNATURE)
    _build.launch(fn, "vpu_micro", x.device, _INDEX[variant], x.data_ptr(), y.data_ptr(),
                  x.numel(), _build.stream(x))
    launches += 1
    return y
