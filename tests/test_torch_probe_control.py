"""The control of ``probe_w2v_gradient.py --control``: its reordered conv
block (one GEMM of the stride-2 windows of H, in fp32 or in bf16) must be
the plain block's function with the plain block's gradient, so that the
control's paths differ from the plain path only in the forward's summation
order. The control runs the layer_norm form (no output GELU), as the
UniSpeech model of ``w2v_train`` does. On the CPU, at a small width: the
forward within one bf16 ulp of the plain block's output (two fp32
summation orders, rounded once), the gradients of x and of the kernel
bit-equal to the plain block's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from unispeech_tpu_torch.ops.kernels import conv_stack

FORMS = {  # (gelu_in, affine) of the layer_norm form's blocks (no output GELU)
    "gelu_in": (True, False),
    "affine": (False, True),
    "neither": (False, False),
}


@pytest.fixture
def probe(monkeypatch):
    import pathlib

    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).resolve().parent.parent))
    import probe_w2v_gradient

    return probe_w2v_gradient


@pytest.mark.parametrize("variant", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_reordered_block_is_the_plain_block(probe, variant, k, form):
    from unispeech_tpu_torch.models import encoder

    gelu_in, with_affine = FORMS[form]
    gelu_out = False
    rng = np.random.default_rng(7 + k)
    B, T, C, valid = 2, 41, 48, 38
    x0 = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).bfloat16()
    w0 = torch.from_numpy((rng.standard_normal((k, C, C)) * 0.15).astype(np.float32))
    affine = None
    if with_affine:
        affine = (torch.from_numpy(rng.uniform(0.5, 1.5, (B, C)).astype(np.float32)),
                  torch.from_numpy((rng.standard_normal((B, C)) * 0.1).astype(np.float32)))
    dy = None
    outs = {}
    for path in ("plain", "reordered"):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        if path == "plain":
            y, t_out = conv_stack.conv_gelu_block_plain(x, w, valid, gelu_in, gelu_out, affine)
        else:
            with probe.reordered_frontend(variant):
                y, t_out = encoder.conv_gelu_block(x, w, valid, gelu_in, gelu_out, affine)
        if dy is None:
            dy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)).to(y.dtype)
        gx, gw = torch.autograd.grad(y, (x, w), dy)
        outs[path] = (y.detach().float(), t_out, gx, gw)
    probe.REORDERED_UNEQUAL.clear()
    yp, tp, gxp, gwp = outs["plain"]
    yr, tr, gxr, gwr = outs["reordered"]
    assert tr == tp == (valid - k) // 2 + 1
    assert yr.shape == yp.shape
    # one bf16 ulp at each element's scale (at most 2^-7 relative)
    ulp = torch.clamp(yp.abs(), min=1e-3) * 2.0 ** -7
    assert bool(((yr - yp).abs() <= ulp).all())
    assert torch.equal(gxr, gxp)
    assert torch.equal(gwr, gwp)


@pytest.mark.parametrize("variant", ["fp32", "bf16"])
def test_reordered_block_refuses_the_output_gelu(probe, variant):
    """The plain block's output GELU reads the fp32 sum, which the bf16 GEMM
    does not give: the control covers the layer_norm form alone."""
    from unispeech_tpu_torch.models import encoder

    x = torch.zeros((1, 9, 16), dtype=torch.bfloat16)
    w = torch.zeros((3, 16, 16))
    with probe.reordered_frontend(variant), pytest.raises(ValueError, match="layer_norm"):
        encoder.conv_gelu_block(x, w, 9, True, True, None)
