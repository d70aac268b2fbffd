"""Fused strided-conv1d + GELU blocks of the waveform frontend.

Counterpart of the JAX package's ``ops/pallas/conv_stack.py``: one block
computes y = gelu?(conv_{k in {2,3}, s=2}(gelu_in?(x*a + b))), where (a, b)
is the frontend GroupNorm folded in as a per-(batch, channel) affine, and
its backward (dx, dW, da, db from the saved bf16 pre-activation). GELU and
its derivative are exact erf (the TPU kernel's polynomials exist only
because Mosaic has no erf). CUDA tensors go to the kernels in
``csrc/conv_stack.cu`` (bf16) and ``csrc/conv_stack_f32.cu`` (fp32, both
directions: the GEMMs as 3xTF32 products on TF32 ``wgmma``, each operand
split into TF32 hi and lo once per tile, so fp32 to a few ulps); CPU
tensors to the plain versions below. ``gemm_weight`` and ``dw_split_plan``
give the forward's weight layout and the dW kernel's split of the rows,
which the CPU tests hold against the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops.fp32_conv import conv1d
from unispeech_tpu_torch.ops.kernels import _build

launches = 0  # forward kernel launches made by the blocks (the H pass and the GEMM)
backward_launches = 0  # backward kernel launches made by conv_gelu_block_backward

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_P] * 7 + [_I] * 8 + [_P]
_BWD_SIGNATURE = [_P] * 12 + [_I] * 8 + [_P]
_BWD_F32_SIGNATURE = [_P] * 12 + [_I] * 9 + [_P]  # and the dW split's steps
BWD_DX, BWD_DW = 1, 2  # the backward's two GEMMs, as bits of ``parts``
DW_STEP_ROWS = 32  # rows of one K step of the fp32 dW kernel (inside one utterance)
TILE = 128  # the fp32 GEMMs' tile: 128 rows x 128 channels per block, one per SM

Affine = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _check(kernel: torch.Tensor, valid_len: int, ts: int) -> int:
    k, cin, cout = kernel.shape
    if k not in (2, 3) or cin != cout:
        raise ValueError(
            f"conv block takes a (k, C, C) kernel with k in (2, 3), got {tuple(kernel.shape)}")
    if not k <= valid_len <= ts:
        raise ValueError(f"valid_len {valid_len} outside [{k}, {ts}]")
    return (valid_len - k) // 2 + 1


def _block_input(x, valid_len, gelu_in, affine):
    """(x^, H): the dtype-rounded affine of the valid rows, and the conv's
    input (x^ after the input GELU, rounded)."""
    h = x[:, :valid_len]
    if affine is not None:
        a, b = affine
        h = (h.float() * a.float()[:, None, :] + b.float()[:, None, :]).to(x.dtype)
    xh = h
    if gelu_in:
        h = F.gelu(h.float()).to(x.dtype)
    return xh, h


def dgelu(x: torch.Tensor) -> torch.Tensor:
    """Exact derivative of the erf GELU, Phi(x) + x * phi(x), in fp32. The
    erf is taken in fp64 and rounded: in about 1 process in 40 the CPU's
    fp32 ``torch.erf`` saturates over a run of elements (erf(2.61) = 1.0,
    not 0.99978), which made the plain backward differ from run to run."""
    x = x.float()
    phi = torch.erf(x.double() * 0.7071067811865476).float()
    return 0.5 * (1.0 + phi) + x * 0.3989422804014327 * torch.exp(-0.5 * x * x)


def conv_gelu_block_plain(x, kernel, valid_len: int, gelu_in: bool = False,
                          gelu_out: bool = True, affine: Affine = None,
                          return_pre: bool = False):
    """Plain version: the same roundings as the kernel, the conv in fp32
    (``fp32_conv.conv1d``: no TF32) on the dtype-rounded operands. With ``return_pre``
    also the dtype-rounded pre-activation (the conv output before the
    output GELU)."""
    t_out = _check(kernel, valid_len, x.shape[1])
    _, h = _block_input(x, valid_len, gelu_in, affine)
    w = kernel.to(x.dtype).float().permute(2, 1, 0)  # (C_out, C_in, k)
    y = conv1d(h.float().transpose(1, 2), w, stride=2).transpose(1, 2)
    pre = y.to(x.dtype).contiguous()
    if gelu_out:
        y = F.gelu(y)
    y = y.to(x.dtype).contiguous()
    return (y, t_out, pre) if return_pre else (y, t_out)


def conv_gelu_block_backward_plain(x, kernel, valid_len: int, gelu_in: bool,
                                   gelu_out: bool, affine: Affine, dy, pre):
    """Plain version of the block's backward, in the kernel's arithmetic:
    g = dtype(gelu'(pre) * dy); dx^[2t + p] = sum_p g[t] . W_p^T (fp32), times
    gelu'(x^) with the input GELU; da = sum_t dx^ * x, db = sum_t dx^,
    dx = dtype(dx^ * a), zero past valid_len; dW_p = sum_t H[2t + p]^T . g
    in fp32. Returns (dx, dW (k, C, C) fp32, da, db); da/db None without
    the affine."""
    k = kernel.shape[0]
    t_out = _check(kernel, valid_len, x.shape[1])
    B, ts, C = x.shape
    xh, h = _block_input(x, valid_len, gelu_in, affine)
    g = dgelu(pre) * dy.float() if gelu_out else dy.float()
    g = g.to(x.dtype).float()
    w = kernel.to(x.dtype).float()  # (k, C_in, C_out)
    dxh = torch.zeros((B, valid_len, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, C, C), dtype=torch.float32, device=x.device)
    hf = h.float()
    for p in range(k):
        dxh[:, p:p + 2 * t_out:2] += g @ w[p].t()
        dw[p] = hf[:, p:p + 2 * t_out:2].reshape(-1, C).t() @ g.reshape(-1, C)
    if gelu_in:
        dxh = dxh * dgelu(xh)
    da = db = None
    if affine is not None:
        xv = x[:, :valid_len].float()
        da = (dxh * xv).sum(1)
        db = dxh.sum(1)
        dxh = dxh * affine[0].float()[:, None, :]
    dx = torch.zeros_like(x)
    dx[:, :valid_len] = dxh.to(x.dtype)
    return dx, dw, da, db


def gemm_weight(kernel: torch.Tensor) -> torch.Tensor:
    """The forward GEMM's right operand: the (k, C_in, C_out) kernel as
    (C_out, k * C_in), row n = W[:, :, n] flattened, contiguous. Both
    dtypes' forward kernels read it K-major (TF32 ``wgmma`` takes a
    shared-memory operand in no other layout)."""
    k, cin, cout = kernel.shape
    return kernel.reshape(k * cin, cout).t().contiguous()


def dw_split_plan(B: int, t_out: int, C: int, k: int, sms: int) -> Tuple[int, int]:
    """(steps per split, splits) of the fp32 dW kernel's split-K: the B *
    ceil(t_out / 32) steps (32 rows inside one utterance each) go to
    ``splits`` blocks per (tap, 128 x 128) tile, consecutive steps each, the
    count chosen among one to four waves of ``sms`` blocks for the fullest
    last wave (the fewest waves among equals)."""
    steps = B * -(-t_out // DW_STEP_ROWS)
    tiles = k * (C // TILE) ** 2
    best = None
    for waves in range(1, 5):
        per = -(-steps // max(1, min(steps, waves * sms // tiles)))
        splits = -(-steps // per)
        blocks = tiles * splits
        fill = blocks / (-(-blocks // sms) * sms)
        if best is None or fill > best[0] + 0.02:
            best = (fill, per, splits)
    return best[1], best[2]


def _check_cuda(x, kernel, valid_len, affine):
    """Raise for CUDA inputs the kernels do not take; returns the geometry,
    the kernel in x's dtype and the fp32 affine."""
    B, ts, C = x.shape
    t_out = _check(kernel, valid_len, ts)
    req = _build.require
    req(x.dtype in _build.COMPUTE_DTYPES and x.is_contiguous(),
        f"conv block kernels take a contiguous bf16 or fp32 (B, T, C) input, got {x.dtype}")
    req(kernel.dtype in (torch.float32, x.dtype),
        f"conv block kernel of {kernel.dtype} with a {x.dtype} input")
    req(kernel.shape[1] == C and C % 128 == 0,
        f"conv block kernel takes C % 128 == 0 channels matching x, got {C}")
    req(kernel.device == x.device, "kernel and input on different devices")
    ab = None
    if affine is not None:
        ab = tuple(t.to(torch.float32).contiguous() for t in affine)
        # the kernels read them as float4: 16-byte aligned
        ab = tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ab)
        req(all(t.shape == (B, C) and t.device == x.device for t in ab),
            "affine must be two (B, C) tensors on x's device")
    return B, ts, C, t_out, kernel.to(x.dtype).contiguous(), ab


def _forward(x, kernel, valid_len, gelu_in, gelu_out, affine, want_pre):
    """(y, t_out, pre): pre (the dtype-rounded pre-activation) only with
    ``want_pre``, else None."""
    global launches
    if not x.is_cuda:
        y, t_out, pre = conv_gelu_block_plain(x, kernel, valid_len, gelu_in, gelu_out,
                                              affine, return_pre=True)
        return y, t_out, pre if want_pre else None
    B, ts, C, t_out, w, ab = _check_cuda(x, kernel, valid_len, affine)
    k = kernel.shape[0]
    w = gemm_weight(w)
    entry = "usk_conv_gelu_block"
    if x.dtype == torch.float32:
        # the fp32 loaders read x (or H) by TMA and W by 16-byte loads
        entry = "usk_conv_gelu_block_f32"
        x = x.clone() if x.data_ptr() % 16 else x
    y = torch.empty((B, t_out, C), dtype=x.dtype, device=x.device)
    pre = torch.empty_like(y) if want_pre else None
    # H = gelu_in?(x * a + b) of the valid rows, written once by an
    # elementwise pass before the GEMM
    h_buf = (torch.empty((B, valid_len, C), dtype=x.dtype, device=x.device)
             if ab is not None or gelu_in else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.function(entry, _SIGNATURE)
    _build.launch(fn, "conv_gelu_block", x.device, x.data_ptr(), w.data_ptr(),
                  ptr(None if ab is None else ab[0]), ptr(None if ab is None else ab[1]),
                  ptr(h_buf), y.data_ptr(), ptr(pre), B, ts, valid_len, t_out, C, k,
                  int(gelu_in), int(gelu_out), _build.stream(x))
    launches += 1 + (h_buf is not None)  # the GEMM, after the H pass where there is one
    return y, t_out, pre


def conv_gelu_block_backward(x, kernel, valid_len: int, gelu_in: bool, gelu_out: bool,
                             affine: Affine, dy, pre):
    """The block's backward from its cotangent dy (B, t_out, C) and the
    saved pre-activation (used with the output GELU). CPU tensors take the
    plain version; a CUDA tensor launches the kernels or raises. Returns
    (dx (B, T, C), dW (k, C, C) fp32, da, db) as the plain version."""
    if not x.is_cuda:
        return conv_gelu_block_backward_plain(x, kernel, valid_len, gelu_in, gelu_out,
                                              affine, dy, pre)
    return backward_parts(x, kernel, valid_len, gelu_in, gelu_out, affine, dy, pre,
                          BWD_DX | BWD_DW)


def _check_backward(x, kernel, valid_len, gelu_out, affine, dy, pre):
    """Raise for a backward the kernels do not take: dy, and pre with the
    output GELU, in x's dtype and the block's output shape. Returns what
    ``_check_cuda`` returns."""
    B, ts, C, t_out, w, ab = _check_cuda(x, kernel, valid_len, affine)
    req = _build.require
    req(dy.dtype == x.dtype and dy.shape == (B, t_out, C) and dy.device == x.device,
        f"dy must be {x.dtype} (x's) ({B}, {t_out}, {C}), got {dy.dtype} {tuple(dy.shape)}")
    if gelu_out:
        req(pre is not None and pre.shape == dy.shape and pre.dtype == x.dtype
            and pre.is_contiguous() and pre.device == x.device,
            f"the output GELU's backward needs a contiguous {x.dtype} pre of dy's shape")
    return B, ts, C, t_out, w, ab


def backward_parts(x, kernel, valid_len: int, gelu_in: bool, gelu_out: bool, affine: Affine,
                   dy, pre, parts: int):
    """The backward's kernels on CUDA tensors: the g and H passes where they
    run, then those of the GEMMs dx and dW that ``parts`` names. With one
    GEMM left out, its output is left unwritten; this times each GEMM alone."""
    global backward_launches
    B, ts, C, t_out, w, ab = _check_backward(x, kernel, valid_len, gelu_out, affine, dy, pre)
    k = kernel.shape[0]
    dy = dy.contiguous()
    if x.dtype == torch.float32:
        # the fp32 kernels read every operand by 16-byte copies
        x, w, dy = (t.clone() if t.data_ptr() % 16 else t for t in (x, w, dy))
        if gelu_out and pre.data_ptr() % 16:
            pre = pre.clone()
    dev = x.device
    g_buf = torch.empty_like(dy) if gelu_out else None
    h_buf = (torch.empty((B, valid_len, C), dtype=x.dtype, device=dev)
             if ab is not None or gelu_in else None)
    dx = torch.empty_like(x)
    dw = torch.zeros((k, C, C), dtype=torch.float32, device=dev)
    da = db = None
    if ab is not None:
        da = torch.zeros((B, C), dtype=torch.float32, device=dev)
        db = torch.zeros((B, C), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    if x.dtype == torch.float32:
        fn = _build.function("usk_conv_gelu_block_bwd_f32", _BWD_F32_SIGNATURE)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        extra = (dw_split_plan(B, t_out, C, k, sms)[0],)
    else:
        fn = _build.function("usk_conv_gelu_block_bwd", _BWD_SIGNATURE)
        extra = ()
    _build.launch(fn, "conv_gelu_block_backward", dev, x.data_ptr(), w.data_ptr(),
                  ptr(None if ab is None else ab[0]), ptr(None if ab is None else ab[1]),
                  dy.data_ptr(), ptr(pre if gelu_out else None), ptr(g_buf), ptr(h_buf),
                  dx.data_ptr(), dw.data_ptr(), ptr(da), ptr(db), B, ts, valid_len, t_out,
                  C, k, int(gelu_in), parts, *extra, _build.stream(x))
    # dx and dW, after the g pass (output GELU) and the H pass where they run
    backward_launches += (bool(parts & BWD_DX) + bool(parts & BWD_DW) + (g_buf is not None)
                          + (h_buf is not None))
    return dx, dw, da, db


class _ConvBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, a, b, valid_len, gelu_in, gelu_out):
        affine = None if a is None else (a, b)
        y, _, pre = _forward(x, kernel, valid_len, gelu_in, gelu_out, affine,
                             want_pre=gelu_out)
        ctx.args = (valid_len, gelu_in, gelu_out)
        ctx.save_for_backward(x, kernel, a, b, pre)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, a, b, pre = ctx.saved_tensors
        valid_len, gelu_in, gelu_out = ctx.args
        affine = None if a is None else (a, b)
        dx, dw, da, db = conv_gelu_block_backward(x, kernel, valid_len, gelu_in, gelu_out,
                                                  affine, dy.to(x.dtype), pre)
        return dx, dw.to(kernel.dtype), da, db, None, None, None


def conv_gelu_block(x: torch.Tensor, kernel: torch.Tensor, valid_len: int,
                    gelu_in: bool = False, gelu_out: bool = True,
                    affine: Affine = None):
    """One fused frontend stage on x (B, T, C), the first ``valid_len`` rows
    valid; kernel (k, C, C) in the JAX (k, in, out) layout, stride 2.
    ``affine`` ((B, C), (B, C)) fp32 applies x*a + b before gelu_in.
    Returns (y, t_out) with y (B, t_out, C), t_out = (valid_len - k)//2 + 1.
    Differentiable in x, kernel and the affine. CPU tensors take the plain
    versions; a CUDA tensor launches the kernels (bf16 or fp32 x, the
    kernel fp32 or x's dtype, C % 128 == 0) or raises."""
    a, b = (None, None) if affine is None else affine
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, kernel, a, b)):
        t_out = _check(kernel, valid_len, x.shape[1])
        if a is not None:
            a, b = a.to(torch.float32), b.to(torch.float32)
        return _ConvBlock.apply(x, kernel, a, b, valid_len, gelu_in, gelu_out), t_out
    y, t_out, _ = _forward(x, kernel, valid_len, gelu_in, gelu_out, affine, want_pre=False)
    return y, t_out
