"""The fp32 attention backward above head dim 64, on the CPU.

The kernel (``csrc/flash_attention_bwd_f32.cu``, its width-80 / width-96
form in ``flash_attention_bwd_f32_mid.cu``, their shared pieces in
``flash_attention_bwd_f32.cuh``) runs only on the card.
These tests hold what its host side and its layout decide, at head dims 72,
80, 120 and 128 (and 88, 96 where a width is at stake):
- the width each head dim runs at (``flash_attention.f32_width``)
  against the source's dispatch; the width-80 / width-96 form's shared
  memory (its formulas read from the source) within a block's 227 KB, its
  swizzled tiles 1024-byte aligned, and its fp32 K / V rows read without a
  bank conflict by the fragments' row reads (float2) and column reads;
- the operand layouts, emulated in plain torch at the kernel's tiles (64
  keys, 32-query steps): S^T's k order (K's fragment takes columns 2t and
  2t + 1 as k t and t + 4; the q / dO tiles store their columns in that
  order), each operand split once into TF32 hi + lo (cvt.rna: nearest,
  ties away) and three products per k step, dK / dV from a fresh sum per
  step, dq^T in two passes of 64 rows (rows past the width zero), columns
  from hd to the width zero in every tile, dq^'s 32-column staging boxes
  clipped at hd, and the exit of a key tile whose keys are all padded;
  against ``fused_attention_backward_plain`` (relative L2 1e-5, the card's
  fp32 rule) and jax.grad through the Pallas kernels in interpret mode
  (rtol 1e-4, atol 1e-5 of the gradient's scale, as
  ``test_torch_fp32_train.py``). At hd 120 and 128 the card runs the
  3xTF32 mma.sync form at width 128; the emulation holds the same products
  at that width.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.pallas.flash_attention import fused_attention as jax_fused
from unispeech_tpu_torch.ops.attention import scale_in_dtype
from unispeech_tpu_torch.ops.kernels import flash_attention as fa

CSRC = pathlib.Path(fa.__file__).resolve().parents[2] / "csrc"
SOURCES = [CSRC / f"flash_attention_bwd_f32{x}" for x in (".cuh", ".cu", "_mid.cu")]
HDS = [72, 80, 120, 128]
BKEY, QS = 64, 32  # keys per block, queries per step
PAD_NEG = -(2.0 ** 100)  # a padded key's additive mask in the kernel
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source() -> str:
    return "\n".join(p.read_text() for p in SOURCES)


def _eval(expr: str, env: dict) -> int:
    """A C integer expression of the source in Python (integer division)."""
    expr = expr.replace("(int)", "").replace("/", "//")
    return int(eval(expr, {}, dict(env)))


def _file_constants() -> dict:
    env = {}
    for name, expr in re.findall(r"^constexpr (?:int|uint32_t) (k\w+) = ([^;]+);", _source(),
                                 re.M):
        try:
            env[name] = _eval(expr, env)
        except Exception:  # float constants and the like
            pass
    return env


def _mid_layout(kD: int) -> dict:
    """MidLayout<kD>'s members, from the struct's formulas in the source."""
    body = re.search(r"struct MidLayout \{(.*?)\n\};", _source(), re.S).group(1)
    env = dict(_file_constants(), kD=kD)
    for name, expr in re.findall(r"static constexpr (?:int|uint32_t) (k\w+) = ([^;]+);", body):
        env[name] = _eval(expr, env)
    return env


@pytest.mark.parametrize("hd", [8, 64, 72, 80, 88, 96, 104, 120, 128])
def test_width_follows_the_source_dispatch(hd):
    """The host's width per head dim is the kernel's: <= 64 the width-64
    form, <= 80 and <= kMidMaxHd the width-80 / width-96 form
    (``launch_mid_any<80>`` / ``<96>``), above it the width-128 form."""
    src = _source()
    const = _file_constants()
    assert re.search(r"if \(a\.hd <= 64\) \{", src)
    assert re.search(r"if \(a\.hd <= 80\) return launch_mid_any<80>", src)
    assert re.search(r"if \(a\.hd <= kMidMaxHd\) return launch_mid_any<96>", src)
    assert fa.F32_WIDTHS == (64, 80, const["kMidMaxHd"], const["kMaxHd"])
    want = 64 if hd <= 64 else 80 if hd <= 80 else 96 if hd <= const["kMidMaxHd"] else 128
    assert fa.f32_width(hd) == want
    assert fa.kernel_head_dim(hd) == hd


@pytest.mark.parametrize("kD", [80, 96])
def test_mid_layout_fits_and_aligns(kD):
    """The width-80 / width-96 form's shared memory fits a block; its
    wgmma tiles and staging boxes start on 1024-byte boundaries; its fp32
    rows (K, V, the q / dO staging) are whole 16-byte units for cp.async;
    q / dO tiles hold kD columns in atoms of 32."""
    L = _mid_layout(kD)
    limit = _file_constants()["kSmemMax"]
    assert L["kSmem"] <= limit == 232448
    for off in ("kOffGdBox", "kOffQ", "kOffD", "kOffQt", "kOffDt", "kOffS", "kOffK"):
        assert L[off] % 1024 == 0, off
    assert L["kQTile"] % 1024 == 0 and L["kQtTile"] % 1024 == 0
    assert (L["kLd"] * 4) % 16 == 0 and L["kLd"] >= kD and (kD * 4) % 16 == 0
    assert 32 * L["kAtoms"] >= kD and L["kAtoms"] == math.ceil(kD / 32)
    # the dq^ staging: one 32-column box per atom; dq^T's second pass writes
    # columns 64 .. 32 kAtoms - 1 of it
    assert L["kOffGdBox"] == L["kAtoms"] * 32 * 32 * 4
    assert 64 < kD <= 128


def test_width_128_does_not_fit_the_mid_layout():
    """Why hd 104-128 keep the width-128 form: the same layout at 128
    columns needs more than a block's shared memory."""
    assert _mid_layout(128)["kSmem"] > _file_constants()["kSmemMax"]
    assert _mid_layout(96)["kSmem"] <= _file_constants()["kSmemMax"]


@pytest.mark.parametrize("kD", [80, 96])
def test_fragment_reads_meet_no_bank_twice(kD):
    """K / V rows of kLd floats (kLd % 32 = 8 or 24): S^T's A fragments
    (lane g, t reads row 16 w + g (+ 8), columns 8 kk + 2 t, + 1 as one
    float2; a 64-bit access serves 16 lanes per pass) and dq^T's (lane g, t
    reads column 16 w + g (+ 8) (+ 64 p) of rows 8 kk + t (+ 4)) each hit
    32 distinct banks."""
    ld = _mid_layout(kD)["kLd"]
    assert ld % 32 in (8, 24)
    for w in range(4):
        for kk in range(kD // 8):
            for i in (0, 1):
                for half in (0, 1):
                    words = [(16 * w + g + 8 * i) * ld + 8 * kk + 2 * t
                             for g in range(4 * half, 4 * half + 4) for t in range(4)]
                    assert len({(x % 32) // 2 for x in words}) == 16
        for kk in range(BKEY // 8):
            for p in (0, 1):
                if 16 * w + 64 * p >= kD:
                    continue
                for i in (0, 1):
                    for j in (0, 1):
                        words = [(8 * kk + t + 4 * j) * ld + 16 * w + g + 8 * i + 64 * p
                                 for g in range(8) for t in range(4)]
                        assert len({x % 32 for x in words}) == 32


def _store_position(kD: int) -> list:
    """The k position the q / dO tiles store each column at: the thread with
    columns qc .. qc + 3 writes (qc, qc + 2) at p0, p0 + 1 and (qc + 1,
    qc + 3) at p0 + 4, p0 + 5, p0 = (qc & ~7) + (qc & 4) / 2."""
    pos = [None] * kD
    for qc in range(0, kD, 4):
        p0 = (qc & ~7) + (qc & 4) // 2
        pos[qc], pos[qc + 2], pos[qc + 1], pos[qc + 3] = p0, p0 + 1, p0 + 4, p0 + 5
    return pos


def _fragment_column(kD: int) -> list:
    """The column K's A fragment takes at each k position: k t <-> 2 t and
    k t + 4 <-> 2 t + 1 within each 8."""
    return [8 * (p // 8) + (2 * (p % 8) if p % 8 < 4 else 2 * (p % 8 - 4) + 1)
            for p in range(kD)]


@pytest.mark.parametrize("kD", [80, 96, 128])
def test_k_order_of_the_q_tiles_is_the_fragments(kD):
    """Every column lands at the k position whose fragment column it is, and
    the positions are a permutation of each group of 8; the source stores
    and reads by these rules."""
    src = _source()
    for text in ("const int p0 = (qc & ~7) + (qc & 4) / 2;",
                 "store_split2(Qh, Ql, usk::sw_tf32(r, p0, kQS), x[m].x, x[m].z);",
                 "store_split2(Qh, Ql, usk::sw_tf32(r, p0 + 4, kQS), x[m].y, x[m].w);",
                 "const int c = 8 * kk + 2 * tq;",
                 "usk::split_tf32(k0.x, kh[bf][0], kl[bf][0]);",
                 "usk::split_tf32(k0.y, kh[bf][2], kl[bf][2]);"):
        assert text in src, text
    pos, col = _store_position(kD), _fragment_column(kD)
    assert sorted(pos) == list(range(kD))
    assert all(col[pos[c]] == c for c in range(kD))
    assert all(pos[c] // 8 == c // 8 for c in range(kD))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away from 0."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _prod3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products of the operands split once (lo.hi +
    hi.lo + hi.hi), summed in fp32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulate(q, k, v, bias, gate, kpm, rate, seed, out, lse, dout):
    """The wide backward's dataflow in plain torch: per (utterance, head,
    64-key tile), 32-query steps over the tiles' operands at the kernel's
    width, the padded-tile exit, dq^'s boxes clipped at hd. Returns (dq,
    dk, dv, dbias, dgate) as the wrapper does."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    kD = fa.f32_width(hd)
    qk, kscale = fa.kernel_q(q)
    pad = lambda x: torch.nn.functional.pad(x, (0, kD - hd))  # noqa: E731
    qp, kp, vp, dp = pad(qk), pad(k), pad(v), pad(dout)
    delta = (dout * out).sum(-1)  # (B, T, H)
    c_all = fa._keep_scale(q, k, rate, seed)
    col = _fragment_column(kD)  # S^T's k positions -> columns
    n_boxes = math.ceil(kD / 32)
    dq = torch.zeros(B, T, H, hd)
    dk, dv = torch.zeros(B, S, H, hd), torch.zeros(B, S, H, hd)
    dbias = torch.zeros(H, T, S) if bias is not None else None
    dgate = torch.zeros(B, H, T) if gate is not None else None
    for b in range(B):
        row_open = kpm is None or bool((~kpm[b]).any())
        for h in range(H):
            for s0 in range(0, S, BKEY):
                n = min(BKEY, S - s0)
                keys = slice(s0, s0 + n)
                if kpm is not None and row_open and not bool((~kpm[b, keys]).any()):
                    continue  # the padded-tile exit: dK, dV stay 0
                K, V = torch.zeros(BKEY, kD), torch.zeros(BKEY, kD)
                K[:n], V[:n] = kp[b, keys, h], vp[b, keys, h]
                colneg = torch.full((BKEY,), -math.inf)
                colneg[:n] = 0.0 if kpm is None else torch.where(kpm[b, keys], PAD_NEG, 0.0)
                dK, dV = torch.zeros(BKEY, kD), torch.zeros(BKEY, kD)
                for t0 in range(0, T, QS):
                    m = min(QS, T - t0)
                    rows = slice(t0, t0 + m)
                    Q, D = torch.zeros(QS, kD), torch.zeros(QS, kD)
                    Q[:m], D[:m] = qp[b, rows, h], dp[b, rows, h]
                    lse2 = torch.full((QS,), math.inf)
                    lse2[:m] = lse[b, h, rows] * LOG2E
                    dl = torch.zeros(QS)
                    dl[:m] = delta[b, rows, h]
                    x = _prod3(K[:, col], Q[:, col].t()) * kscale  # S^T (key, query)
                    dpt = _prod3(V[:, col], D[:, col].t())
                    bv = torch.zeros(BKEY, QS)
                    g = torch.ones(QS)
                    if bias is not None:
                        bv[:n, :m] = bias[h, rows, keys].t()
                        if gate is not None:
                            g[:m] = gate[b, h, rows]
                        x = x + g[None, :] * bv
                    x = x + colneg[:, None]
                    p = torch.exp2(x * LOG2E - lse2[None, :])
                    cc = torch.ones(BKEY, QS)
                    if c_all is not None:
                        cc = torch.zeros(BKEY, QS)
                        cc[:n, :m] = c_all[b, h, rows, keys].t()
                    ds = p * (cc * dpt - dl[None, :])
                    dV = dV + _prod3(p * cc, D)  # a fresh sum per step, one add
                    dK = dK + _prod3(ds, Q)
                    # dq^T in two 64-row passes, rows past kD zero
                    kt = torch.zeros(128, BKEY)
                    kt[:kD] = K.t()
                    dqt = torch.cat([_prod3(kt[64 * p_:64 * p_ + 64], ds)
                                     for p_ in range(2)])  # (128 columns, 32 queries)
                    for bx in range(n_boxes):  # the boxes, clipped at hd and T
                        c0, c1 = 32 * bx, min(32 * bx + 32, hd)
                        if c0 < hd:
                            dq[b, rows, h, c0:c1] += dqt[c0:c1, :m].t()
                    if bias is not None:
                        dbias[h, rows, keys] += (g[None, :] * ds).t()[:m, :n]
                        if gate is not None:
                            dgate[b, h, rows] += (ds * bv).sum(0)[:m]
                dk[b, keys, h] = dK[:n, :hd] * kscale
                dv[b, keys, h] = dV[:n, :hd]
    return dq * scale_in_dtype(hd, q.dtype), dk, dv, dbias, dgate


def _inputs(hd, with_bias, rate, seed_val=7):
    """B = 3 rows of T = 70 frames (two key tiles, three query steps):
    lengths 70, 45 (its second tile all padded) and 0 (dO 0 on it)."""
    B, T, H = 3, 70, 2
    rng = np.random.RandomState(hd + 10 * with_bias)
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32)) for _ in range(3))
    lengths = torch.tensor([70, 45, 0])
    kpm = torch.arange(T)[None, :] >= lengths[:, None]
    bias = gate = None
    if with_bias:
        bias = torch.from_numpy(rng.randn(H, T, T).astype(np.float32))
        gate = torch.from_numpy(rng.rand(B, H, T).astype(np.float32) * 2 + 1)
    seed = torch.tensor([seed_val], dtype=torch.int64) if rate > 0 else None
    dout = torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32))
    dout[2] = 0.0
    out, lse = fa.fused_attention_plain(q, k, v, bias, gate, kpm, dropout_rate=rate,
                                        dropout_seed=seed, return_lse=True)
    return q, k, v, bias, gate, kpm, rate, seed, out, lse, dout


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("form", ["nobias_drop", "bias_gate"])
def test_emulated_layout_matches_the_plain_backward(hd, form):
    """The emulated dataflow against the plain backward: dq, dk, dv, dbias,
    dgate within relative L2 1e-5; the second row's all-padded key tile
    leaves dk, dv exactly 0 on both sides."""
    args = _inputs(hd, form == "bias_gate", 0.1 if form == "nobias_drop" else 0.0)
    got = _emulate(*args)
    want = fa.fused_attention_backward_plain(*args[:3], *args[3:6], None, *args[6:])
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) <= 1e-5
    for x in (got[1], got[2], want[1], want[2]):
        assert torch.equal(x[1, 64:], torch.zeros_like(x[1, 64:]))


@pytest.mark.parametrize("hd", HDS)
def test_emulated_layout_matches_pallas(hd):
    """The emulated dataflow, on the plain forward's out and lse, against
    jax.grad through the Pallas kernels in interpret mode (gated bias, key
    padding; no dropout: the two packages draw other masks)."""
    q, k, v, bias, gate, kpm, rate, seed, out, lse, dout = _inputs(hd, True, 0.0)

    def jloss(qq, kk, vv, bb, gg):
        o = jax_fused(qq, kk, vv, bb, gg, key_padding_mask=jnp.asarray(kpm.numpy()),
                      interpret=True)
        return jnp.sum(o * jnp.asarray(dout.numpy()))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, bias, gate)))
    got = _emulate(q, k, v, bias, gate, kpm, rate, seed, out, lse, dout)
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


def test_padded_tile_exit_needs_an_open_key():
    """A key tile whose keys are all padded adds nothing in a row with an
    open key (p exactly 0 there), but in a row of length 0 every key is as
    padded as the rest: p is uniform and dv is not 0 unless dO is. So the
    kernel exits on such a tile only when its row has an open key."""
    q, k, v, bias, gate, kpm, rate, seed, out, lse, dout = _inputs(80, False, 0.0)
    dout = torch.randn(dout.shape, generator=torch.Generator().manual_seed(3))
    want = fa.fused_attention_backward_plain(q, k, v, None, None, kpm, None, 0.0, None, out,
                                             lse, dout)
    assert torch.equal(want[2][1, 64:], torch.zeros_like(want[2][1, 64:]))
    assert torch.equal(want[1][1, 64:], torch.zeros_like(want[1][1, 64:]))
    assert want[2][2].abs().max() > 0  # the row of length 0
