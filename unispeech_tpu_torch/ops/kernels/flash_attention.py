"""Fused attention with WavLM's gated relative position bias, with dropout.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``:
softmax(q*scale . k^T + gate * bias + attn_mask - 1e30 * keypad), dropout on
the probabilities, . v, and its merged backward, without a (B, H, T, S)
tensor in device memory. The CUDA kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu`` in bf16; ``csrc/flash_attention_f32.cu``,
``csrc/flash_attention_bwd_f32.cu`` in fp32) read q/k/v by strides in the natural
(B, T, H*hd) layout, which covers both of the TPU's layouts, at any head dim
up to 128: a multiple of 8 as it is, any other on a copy zero-padded to the
next multiple of 8 (``kernel_head_dim``, ``pad_head``). q is scaled as the
JAX wrapper scales it, bf16(q * bf16(hd**-0.5)) (``kernel_q``). CPU tensors take
the plain versions below, which follow the kernels' arithmetic: bf16 P,
fp32 P.V, normalization by the fp32 row sum at the end; the dropout keep
mask is the same Philox function of (seed, b, h, t, s) on both sides
(``ops/kernels/philox.py``), so forward and backward, kernel and plain
version, draw the identical mask. fp32 q/k/v (the models' default dtype)
launch the fp32 kernels (3xTF32 tensor-core products, nothing rounded to a
narrower type), dropout and backward included.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from unispeech_tpu_torch.ops.attention import scale_in_dtype
from unispeech_tpu_torch.ops.kernels import _build
from unispeech_tpu_torch.ops.kernels.philox import attention_keep, keep_threshold

launches = 0  # forward kernel launches made by fused_attention
backward_launches = 0  # backward kernel launches made by its autograd backward

NEG_INF = -1e30
_P, _L, _I, _U, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_FWD_SIGNATURE = [_P] * 4 + [_L] * 8 + [_P, _L] + [_P] * 4 + [_I] * 5 + [_F, _P, _U, _F, _P]
_BWD_SIGNATURE = ([_P] * 6 + [_L] * 10 + [_P, _L] + [_P] * 8 + [_I] * 5
                  + [_F, _P, _U, _F, _P, _P])
MAX_HEAD_DIM = 128  # the kernels' widest head (two 64-column boxes per row)


def _dropout_scale(rate: float) -> torch.Tensor:
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)


def _check_dropout(dropout_rate: float, dropout_seed) -> None:
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate > 0.0 and (dropout_seed is None or dropout_seed.numel() != 1
                               or dropout_seed.dtype != torch.int64):
        raise ValueError("attention dropout needs a 1-element int64 dropout_seed")


def _keep_scale(q, k, dropout_rate, dropout_seed):
    """(B, H, T, S) fp32 keep/(1-rate) multiplier, or None without dropout."""
    if dropout_rate <= 0.0:
        return None
    B, T, H, _ = q.shape
    keep = attention_keep(dropout_seed.to(q.device), B, H, T, k.shape[1], dropout_rate)
    return torch.where(keep, _dropout_scale(dropout_rate).to(q.device),
                       torch.zeros((), device=q.device))


def _logits(q, k, bias, gate, key_padding_mask, attn_mask):
    """fp32 (B, H, T, S) logits of the pre-scaled q, the gated bias and the
    masks, and the pre-scaled q itself."""
    hd = q.shape[-1]
    qs = q * scale_in_dtype(hd, q.dtype)
    s = torch.einsum("bthd,bshd->bhts", qs.float(), k.float())
    if bias is not None:
        g = gate.float()[..., None] if gate is not None else 1.0
        s = s + g * bias.to(q.dtype).float()[None]
    if attn_mask is not None:
        s = s + attn_mask.float()
    if key_padding_mask is not None:
        s = s + torch.where(key_padding_mask, NEG_INF, 0.0)[:, None, None, :]
    return s, qs


def fused_attention_plain(q, k, v, bias=None, gate=None, key_padding_mask=None,
                          attn_mask=None, dropout_rate: float = 0.0,
                          dropout_seed: Optional[torch.Tensor] = None,
                          return_lse: bool = False):
    """Plain version of ``fused_attention`` on any device."""
    _check_dropout(dropout_rate, dropout_seed)
    s, _ = _logits(q, k, bias, gate, key_padding_mask, attn_mask)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # (B, H, T, 1), taken before dropout
    c = _keep_scale(q, k, dropout_rate, dropout_seed)
    if c is not None:
        p = p * c
    acc = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def fused_attention_backward_plain(q, k, v, bias, gate, key_padding_mask, attn_mask,
                                   dropout_rate, dropout_seed, out, lse, dout):
    """Plain version of the merged backward, in the kernel's arithmetic:
    p = exp(s - lse) recomputed, dP = dO.v^T, delta = rowsum(dO * out),
    dS = p * (c*dP - delta) with the regenerated keep scale c; dq = dS.k
    (then the chain rule through q*scale), dk = dS^T.q_scaled,
    dv = (p*c)^T.dO with dS and p*c rounded to the operands' dtype;
    dgate = rowsum(dS * bias), dbias = sum_b gate * dS in fp32.
    Returns (dq, dk, dv, dbias, dgate); dbias/dgate None without a bias /
    gate."""
    hd = q.shape[-1]
    s, qs = _logits(q, k, bias, gate, key_padding_mask, attn_mask)
    p = torch.exp(s - lse.float()[..., None])
    dof = dout.float()
    dp = torch.einsum("bthd,bshd->bhts", dof, v.float())
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, T, 1)
    c = _keep_scale(q, k, dropout_rate, dropout_seed)
    if c is None:
        pc, ds = p, p * (dp - delta)
    else:
        pc, ds = p * c, p * (c * dp - delta)
    dsc = ds.to(q.dtype).float()
    dq_s = torch.einsum("bhts,bshd->bthd", dsc, k.float())
    dq = dq_s.to(q.dtype) * scale_in_dtype(hd, q.dtype)
    dk = torch.einsum("bhts,bthd->bshd", dsc, qs.float()).to(k.dtype)
    dv = torch.einsum("bhts,bthd->bshd", pc.to(v.dtype).float(), dof).to(v.dtype)
    dbias = dgate = None
    if bias is not None:
        bf = bias.to(q.dtype).float()
        g = gate.float()[..., None] if gate is not None else 1.0
        dbias = (g * ds).sum(0).to(bias.dtype)
        if gate is not None:
            dgate = (ds * bf[None]).sum(-1)
    return dq, dk, dv, dbias, dgate


def kernel_head_dim(hd: int) -> int:
    """The head dim the kernels run at: ``hd`` when it is a multiple of 8
    (rows of whole 16-byte units, as TMA reads them), else the next multiple
    of 8, on a zero-padded copy. Raises above ``MAX_HEAD_DIM``."""
    _build.require(1 <= hd <= MAX_HEAD_DIM,
                   f"attention kernels take head dims 1-{MAX_HEAD_DIM}, got {hd}")
    return -(-hd // 8) * 8


def pad_head(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., d) zero-padded to (..., hd) columns; as it is when d == hd.
    Zero columns add nothing to q.k, P.V or rowsum(dO * out)."""
    d = x.shape[-1]
    return x if d == hd else torch.nn.functional.pad(x, (0, hd - d))


def kernel_q(q: torch.Tensor):
    """(q as the kernels read it, the scale they fold into their fp32
    products). The JAX wrapper feeds its kernels bf16(q * bf16(hd**-0.5)).
    Where that scale is a power of two (hd 16 and 64) the product is q *
    scale exactly, so the kernels take q and multiply by the scale; at any
    other hd they take the rounded product and scale 1."""
    scale = scale_in_dtype(q.shape[-1], q.dtype)
    if scale == 2.0 ** round(math.log2(scale)):
        return q, scale
    return q * scale, 1.0


def _check_cuda(q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_seed):
    """Raise for CUDA inputs the kernels do not take; returns the optional
    inputs in the kernels' types."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    req = _build.require
    dt = q.dtype
    req(dt in _build.COMPUTE_DTYPES, f"attention kernels take bf16 or fp32 q, k, v, not {dt}")
    req(hd % 8 == 0 and 8 <= hd <= MAX_HEAD_DIM,
        f"attention kernels take head dims that are multiples of 8 up to {MAX_HEAD_DIM}, "
        f"got {hd} (see kernel_head_dim)")
    unit = 16 // q.element_size()  # elements per 16 bytes
    for name, t, rows in (("q", q, T), ("k", k, S), ("v", v, S)):
        req(t.dtype == dt and t.device == q.device, f"{name} must be {dt} (q's) on q's device")
        req(t.shape == (B, rows, H, hd), f"{name} has shape {tuple(t.shape)}")
        req(t.stride(3) == 1 and t.stride(2) == hd and t.stride(1) % unit == 0
            and t.stride(0) % unit == 0 and t.data_ptr() % 16 == 0,
            f"{name} must be a (B, T, H*hd) row layout with 16-byte aligned rows")
    if bias is not None:
        req(bias.dtype == dt and bias.shape == (H, T, S) and bias.device == q.device,
            f"bias must be a {dt} (H, T, S) tensor on q's device")
        req(_bias_rows_ok(bias), "bias rows must be whole 16-byte units (see bias_rows)")
    if gate is not None:
        req(bias is not None, "a gate needs a bias")
        req(gate.dtype == torch.float32 and gate.shape == (B, H, T) and gate.is_contiguous()
            and gate.device == q.device, "gate must be a contiguous fp32 (B, H, T) tensor")
    if key_padding_mask is not None:
        req(key_padding_mask.dtype == torch.bool and key_padding_mask.shape == (B, S)
            and key_padding_mask.is_contiguous() and key_padding_mask.device == q.device,
            "key_padding_mask must be a contiguous (B, S) bool tensor on q's device")
    if attn_mask is not None:
        req(attn_mask.dtype == torch.float32 and attn_mask.shape == (T, S)
            and attn_mask.is_contiguous() and attn_mask.device == q.device,
            "attn_mask must be a contiguous fp32 (T, S) tensor on q's device")
    if dropout_seed is not None:
        req(dropout_seed.device == q.device, "dropout_seed must lie on q's device")


def _bias_rows_ok(bias: torch.Tensor) -> bool:
    H, T, S = bias.shape
    rs = bias.stride(1)
    return (bias.stride(2) == 1 and rs % 8 == 0 and rs >= S and bias.stride(0) == rs * T
            and bias.data_ptr() % 16 == 0)


def bias_rows(bias: torch.Tensor) -> torch.Tensor:
    """The (H, T, S) bias in the layout the kernels read: unit inner stride,
    rows a multiple of 8 elements apart (whole 16-byte units of bf16, two
    of fp32), heads T rows apart. A bias in that layout, such as the view
    ``ops/rel_pos.py::compute_rel_pos_bias`` returns, is taken as it is;
    any other is copied into it (differentiably)."""
    if _bias_rows_ok(bias):
        return bias
    S = bias.shape[-1]
    if S % 8 == 0:
        return bias.contiguous()
    return torch.nn.functional.pad(bias, (0, 8 - S % 8))[..., :S]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward_cuda(q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_rate,
                  dropout_seed, want_lse):
    global launches
    hd_in = q.shape[-1]
    hd = kernel_head_dim(hd_in)
    q, scale = kernel_q(q)
    q, k, v = (pad_head(t, hd) for t in (q, k, v))
    _check_cuda(q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_seed)
    B, T, H, _ = q.shape
    S = k.shape[1]
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if want_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            _ptr(bias), 0 if bias is None else bias.stride(1),
            _ptr(gate), _ptr(key_padding_mask), _ptr(attn_mask), _ptr(lse),
            B, T, S, H, hd, scale)
    seed = dropout_seed if dropout_rate > 0.0 else None
    entry = "usk_flash_attention_fwd_f32" if q.dtype == torch.float32 else "usk_flash_attention_fwd"
    fn = _build.function(entry, _FWD_SIGNATURE)
    _build.launch(fn, "fused_attention", q.device, *args, _ptr(seed),
                  keep_threshold(dropout_rate) if seed is not None else 0,
                  float(_dropout_scale(dropout_rate)) if seed is not None else 1.0,
                  _build.stream(q))
    launches += 1
    if hd != hd_in:
        out = out[..., :hd_in].contiguous()
    return out, lse


def _check_backward(q, out, dout) -> None:
    """Raise for a backward the kernels do not take: q in a compute dtype,
    out and dO in q's dtype and shape."""
    req = _build.require
    req(q.dtype in _build.COMPUTE_DTYPES,
        f"attention backward kernels take bf16 or fp32 q, k, v, not {q.dtype}")
    req(dout.dtype == out.dtype == q.dtype and dout.shape == out.shape == q.shape,
        f"dO and out must be {q.dtype} (q's) {tuple(q.shape)}, got {dout.dtype} / "
        f"{out.dtype} {tuple(dout.shape)}")


def _backward_cuda(q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_rate,
                   dropout_seed, out, lse, dout):
    global backward_launches
    hd_in = q.shape[-1]
    hd = kernel_head_dim(hd_in)
    _check_backward(q, out, dout)
    req = _build.require
    dt = q.dtype
    # the kernel's dq^ is unscaled: dq = dt(dq^) * scale below
    scale = scale_in_dtype(hd_in, q.dtype)
    q, kscale = kernel_q(q)
    q, k, v, out, dout = (pad_head(t, hd) for t in (q, k, v, out.contiguous(), dout.contiguous()))
    _check_cuda(q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_seed)
    B, T, H, _ = q.shape
    S = k.shape[1]
    lse = lse.contiguous()
    req(lse.dtype == torch.float32 and lse.shape == (B, H, T), "lse must be fp32 (B, H, T)")
    dev = q.device
    n_qt, n_kt = -(-T // 64), -(-S // 64)
    # cross-block sums into zeroed fp32 buffers: dq^ (over key tiles) and
    # dbias (over the batch, rows padded to whole 64-key tiles) by the TMA
    # unit's tile reductions; dgate by bulk reductions padded to 64-query
    # tiles in bf16, by one atomic per query and block in fp32
    f32 = dt == torch.float32
    dq_acc = torch.zeros((B, T, H, hd), dtype=torch.float32, device=dev)
    dk = torch.empty((B, S, H, hd), dtype=dt, device=dev)
    dv = torch.empty((B, S, H, hd), dtype=dt, device=dev)
    rows = torch.empty((B * H, n_qt, 3, 64), dtype=torch.float32, device=dev)
    dbias_acc = dgate_acc = None
    if bias is not None:
        dbias_acc = torch.zeros((H, T, n_kt * 64), dtype=torch.float32, device=dev)
        if gate is not None:
            dgate_acc = torch.zeros((B * H, T if f32 else n_qt * 64), dtype=torch.float32,
                                    device=dev)
    seed = dropout_seed if dropout_rate > 0.0 else None
    fn = _build.function("usk_flash_attention_bwd_f32" if f32 else "usk_flash_attention_bwd",
                         _BWD_SIGNATURE)
    _build.launch(
        fn, "fused_attention_backward", dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), out.stride(1), dout.stride(0), dout.stride(1),
        _ptr(bias), 0 if bias is None else bias.stride(1),
        _ptr(gate), _ptr(key_padding_mask), _ptr(attn_mask),
        dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dgate_acc), _ptr(dbias_acc),
        B, T, S, H, hd, kscale, rows.data_ptr(),
        keep_threshold(dropout_rate) if seed is not None else 0,
        float(_dropout_scale(dropout_rate)) if seed is not None else 1.0,
        _ptr(seed), _build.stream(q))
    backward_launches += 2  # the rows pre-pass and the backward kernel
    dq = dq_acc.to(dt) * scale
    if hd != hd_in:
        dq, dk, dv = (t[..., :hd_in].contiguous() for t in (dq, dk, dv))
    dbias = None if dbias_acc is None else dbias_acc[..., :S].to(bias.dtype)
    dgate = None if dgate_acc is None else dgate_acc[:, :T].reshape(B, H, T).contiguous()
    return dq, dk, dv, dbias, dgate


def _forward(q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_rate,
             dropout_seed, want_lse):
    if q.is_cuda:
        return _forward_cuda(q, k, v, bias, gate, key_padding_mask, attn_mask,
                             dropout_rate, dropout_seed, want_lse)
    return fused_attention_plain(q, k, v, bias, gate, key_padding_mask, attn_mask,
                                 dropout_rate, dropout_seed, return_lse=True)


def fused_attention_backward(q, k, v, bias, gate, key_padding_mask, attn_mask,
                             dropout_rate, dropout_seed, out, lse, dout):
    """The merged backward: the kernel for CUDA tensors, the plain version
    for CPU tensors. Returns (dq, dk, dv, dbias, dgate)."""
    if q.is_cuda:
        return _backward_cuda(q, k, v, None if bias is None else bias_rows(bias), gate,
                              key_padding_mask, attn_mask, dropout_rate, dropout_seed, out,
                              lse, dout)
    return fused_attention_backward_plain(q, k, v, bias, gate, key_padding_mask,
                                          attn_mask, dropout_rate, dropout_seed,
                                          out, lse, dout)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, gate, key_padding_mask, attn_mask, dropout_rate,
                dropout_seed):
        out, lse = _forward(q, k, v, bias, gate, key_padding_mask, attn_mask,
                            dropout_rate, dropout_seed, want_lse=True)
        ctx.dropout_rate = dropout_rate
        ctx.save_for_backward(q, k, v, bias, gate, key_padding_mask, attn_mask,
                              dropout_seed, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, bias, gate, kpm, amask, seed, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias, dgate = fused_attention_backward(
            q, k, v, bias, gate, kpm, amask, ctx.dropout_rate, seed, out, lse,
            dout.to(q.dtype))
        return dq, dk, dv, dbias, dgate, None, None, None, None


def fused_attention(
    q: torch.Tensor,  # (B, T, H, hd) unscaled
    k: torch.Tensor,  # (B, S, H, hd)
    v: torch.Tensor,  # (B, S, H, hd)
    bias: Optional[torch.Tensor] = None,  # (H, T, S) shared rel-pos bias
    gate: Optional[torch.Tensor] = None,  # (B, H, T) per-query gate
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    attn_mask: Optional[torch.Tensor] = None,  # (T, S) additive fp32
    dropout_rate: float = 0.0,
    dropout_seed: Optional[torch.Tensor] = None,  # 1-element int64
    return_lse: bool = False,
):
    """Attention with the factored gated bias and dropout on the
    probabilities; returns out (B, T, H, hd) and, with ``return_lse``, the
    fp32 log-sum-exp (B, H, T) as well. The bias is read in q's dtype and
    gated in fp32 (gate 1 when only a bias is given); on the card it goes
    through ``bias_rows`` (``compute_rel_pos_bias``'s view is taken as it
    is). Differentiable in q, k, v, bias and gate. CPU tensors take the
    plain versions; a CUDA tensor launches the kernels (bf16 or fp32 q, k,
    v of one dtype, head dim up to ``MAX_HEAD_DIM``) or raises."""
    _check_dropout(dropout_rate, dropout_seed)
    if bias is not None:
        bias = bias.to(q.dtype)
        if q.is_cuda:
            bias = bias_rows(bias)
        if gate is not None:
            gate = gate.to(torch.float32).contiguous()
    else:
        gate = None  # a gate without a bias is unused
    if attn_mask is not None:
        attn_mask = attn_mask.to(torch.float32).contiguous()
    rate = float(dropout_rate)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias, gate))
    if needs_grad:
        out, lse = _FusedAttention.apply(q, k, v, bias, gate, key_padding_mask, attn_mask,
                                         rate, dropout_seed)
    else:
        out, lse = _forward(q, k, v, bias, gate, key_padding_mask, attn_mask, rate,
                            dropout_seed, want_lse=return_lse)
    return (out, lse) if return_lse else out
