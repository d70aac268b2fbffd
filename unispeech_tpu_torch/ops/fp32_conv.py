"""fp32 convolutions that stay fp32 on the card.

PyTorch runs an fp32 cuDNN convolution in TF32 (about three decimal digits)
while ``torch.backends.cudnn.allow_tf32`` is True, its default. The JAX
package computes these convolutions in fp32. ``conv1d`` runs an fp32
convolution, and its backward, with the flag off for the duration of each
call and restores the process's setting after it: a flags context around the
forward alone would not reach the backward, which autograd runs later.
Other dtypes go to ``F.conv1d`` as they are.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def cudnn_fp32():
    """``torch.backends.cudnn.allow_tf32`` False inside, the caller's value
    restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        ctx.has_bias = b is not None
        with cudnn_fp32():
            return F.conv1d(x, w, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        conf = ctx.conf
        gx = gw = gb = None
        with cudnn_fp32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv1d_input(x.shape, w, gy, *conf)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv1d_weight(x, w.shape, gy, *conf)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum((0, 2))
        return gx, gw, gb, None, None, None, None


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Union[int, str] = 0, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv1d`` (x (B, Cin, L), w (Cout, Cin / groups, k)); in fp32 both
    directions run without TF32 whatever the process's cuDNN flag.
    ``padding`` is an int or "same" (stride 1: the (k - 1) * dilation
    padding split with the extra column on the right, as ``F.conv1d``)."""
    if x.dtype != torch.float32:
        return F.conv1d(x, w, b, stride, padding, dilation, groups)
    if padding == "same":
        total = dilation * (w.shape[-1] - 1)
        padding = total // 2
        if total % 2:
            x = F.pad(x, (0, 1))
    return _Conv1d.apply(x, w, b, stride, padding, dilation, groups)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` (zero padding) through ``conv1d``: fp32 without TF32."""

    def _conv_forward(self, input, weight, bias):
        return conv1d(input, weight, bias, self.stride[0], self.padding if isinstance(
            self.padding, str) else self.padding[0], self.dilation[0], self.groups)
