"""The fp32 attention forward's width-80 / width-96 form, on the CPU.

The kernel (``csrc/flash_attention_f32_mid.cu``, launched by
``csrc/flash_attention_f32.cu``'s entry, their shared pieces in
``flash_attention_f32.cuh``) runs only on the card. These tests hold what
its host side and its layout decide, at head dims 72, 80, 88 and 96:
- the width each head dim runs at (``flash_attention.f32_width``) against
  the source's dispatch; the form's shared memory (its formulas read from
  the source) within a block's 227 KB, its swizzled tiles 1024-byte
  aligned; the threads' 16-byte units covering each key tile's K and V
  once, and V^T's keys stored in the order P's fragments take them;
- the dataflow, emulated in plain torch at the kernel's tiles (64 queries,
  64-key steps): q, K, P and V^T split into TF32 hi + lo (cvt.rna:
  nearest, ties away), S as three products per 8-column k step into a
  fresh sum added in fp32, P.V at N = the width with P's k order
  permuted, columns from hd to the width zero, the online softmax in
  natural units with ex2, and the all-padded key tiles skipped (in a row
  with an open key and without a (T, S) mask; a row of length 0 and a
  call with a (T, S) mask run every tile); against
  ``fused_attention_plain`` (relative L2 1e-5, the card's fp32 rule; lse
  within 1e-4 plus 2 fp32 ulps on the rows with a key) and JAX's
  ``fused_attention`` through the Pallas kernel in interpret mode (rtol and
  atol 2e-5, ``test_torch_fp32.py``'s). The Pallas kernel spreads a row
  whose keys are all padded over its tile-padded keys, so against JAX that
  row is held to the mean of v, as ``test_torch_fp32.py`` holds it. The
  rows whose open keys all sit behind the -1e4 band mask have logits near
  -1e4, where one fp32 ulp is 2^-10 and a sum's last bits flip the rounding
  (in the emulation 1e-5 to 5e-5 relative L2 to the plain version, 5e-5 to
  3.4e-4 elementwise to JAX, against 3e-7 and 1.3e-6 on the other rows):
  they are held to 2^-10 (``BEHIND_MASK_TOL``).
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.pallas.flash_attention import fused_attention as jax_fused
from unispeech_tpu_torch.ops.kernels import flash_attention as fa

CSRC = pathlib.Path(fa.__file__).resolve().parents[2] / "csrc"
SOURCES = [CSRC / f"flash_attention_f32{x}" for x in (".cuh", ".cu", "_mid.cu")]
HDS = [72, 80, 88, 96]
BQ, BKEY = 64, 64  # queries per warpgroup, keys per step
PAD_NEG = -(2.0 ** 100)  # a padded key's additive mask in the kernel
LOG2E = 1.4426950408889634
ATTN_TOL = 2e-5
# a row whose open keys all sit behind the -1e4 (T, S) mask has logits near
# -1e4, where one fp32 ulp is 2^-10: each side rounds every logit there to
# within half an ulp, so p, and out with it, carry up to 2^-11 of relative
# rounding on either side, whatever the order of the sums before it
BEHIND_MASK_TOL = 2.0 ** -10


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


def _mid_layout(kD: int, kWG: int = None) -> dict:
    """MidLayout<kD, kWG>'s members, from the struct's formulas in the
    source; kWG by default the warpgroups the launch takes at kD."""
    body = re.search(r"struct MidLayout \{(.*?)\n\};", _source(), re.S).group(1)
    const = _file_constants()
    if kWG is None:
        kWG = const["kWG80"] if kD == 80 else 1
    env = dict(const, kD=kD, kWG=kWG)
    for name, expr in re.findall(r"static constexpr (?:int|uint32_t) (k\w+) = ([^;]+);", body):
        env[name] = _eval(expr, env)
    return env


@pytest.mark.parametrize("hd", [8, 64, 72, 80, 88, 96, 104, 120, 128])
def test_width_follows_the_source_dispatch(hd):
    """The host's width per head dim is the forward kernel's: <= 64 the
    width-64 form, <= 80 and <= kMidMaxHd the width-80 / width-96 form
    (``launch_mid<80>`` / ``<96>``), above it the width-128 form
    (``launch_wide``, flash_attention_f32_wide.cu); the backward runs the
    same widths (one ``f32_width`` for both)."""
    src = _source()
    const = _file_constants()
    assert "if (hd <= 64) return (int)launch_width<64>(a, B, s);" in src
    assert "if (hd <= 80) return (int)launch_mid<80>(a, B, s);" in src
    assert "if (hd <= kMidMaxHd) return (int)launch_mid<96>(a, B, s);" in src
    assert "return (int)launch_wide(a, B, s);" in src
    assert fa.F32_WIDTHS == (64, 80, const["kMidMaxHd"], const["kMaxHd"])
    want = 64 if hd <= 64 else 80 if hd <= 80 else 96 if hd <= const["kMidMaxHd"] else 128
    assert fa.f32_width(hd) == want
    assert fa.kernel_head_dim(hd) == hd


@pytest.mark.parametrize("kD", [80, 96])
def test_mid_layout_fits_and_aligns(kD):
    """The form's shared memory fits a block; its wgmma tiles start on
    1024-byte boundaries; q and K hold kD columns in atoms of 32, V^T kD
    rows; the fp32 staging rows are whole 16-byte units for cp.async; the
    open-tile bits are words after them."""
    L = _mid_layout(kD)
    const = _file_constants()
    assert L["kSmem"] <= const["kSmemMax"] == 232448
    for name in ("kQTile", "kKTile", "kVTile", "kOffK", "kOffV", "kOffRawK"):
        assert L[name] % 1024 == 0, name
    assert L["kAtoms"] == math.ceil(kD / 32) and 32 * L["kAtoms"] >= kD
    assert L["kQTile"] == L["kAtoms"] * L["kBQ"] * 128
    assert L["kKTile"] == L["kAtoms"] * const["kBKey"] * 128
    assert L["kVTile"] == kD * 2 * 128  # two atoms of 32 keys, kD rows each
    assert L["kOffRawV"] - L["kOffRawK"] == BKEY * kD * 4 == L["kOffCol"] - L["kOffRawV"]
    assert L["kOffRawK"] % 16 == 0 and L["kOffRawV"] % 16 == 0 and (kD * 4) % 16 == 0
    assert L["kOffTiles"] == L["kOffCol"] + BKEY * 4
    assert L["kBQ"] == 64 * L["kWG"] and L["kThreads"] == 128 * L["kWG"]
    assert const["kBKey"] == BKEY
    assert "constexpr int wg = kD == 80 ? kWG80 : 1;" in _source()


def test_what_does_not_fit_the_mid_layout():
    """Why hd 104-128 run a width-128 form of their own
    (flash_attention_f32_wide.cu): the same layout at 128 columns needs
    more than a block's shared memory; and why width 96 runs
    one warpgroup: two (128 queries) need more too."""
    limit = _file_constants()["kSmemMax"]
    assert _mid_layout(128, 1)["kSmem"] > limit
    assert _mid_layout(96, 2)["kSmem"] > limit
    assert _mid_layout(80, 2)["kSmem"] <= limit


@pytest.mark.parametrize("kD", [80, 96])
def test_units_cover_each_tile_once(kD):
    """The threads' 16-byte units (the copy and the split of one tile):
    K's cover 64 keys x kD columns once, at distinct raw offsets; V's
    (4 keys x 4 columns each) cover them once too, each thread's V^T
    positions holding the keys that P's fragments take there."""
    L = _mid_layout(kD)
    threads = L["kThreads"]
    assert L["kUnitsK"] * threads == BKEY * kD // 4
    assert L["kItersV"] * threads >= L["kUnitsV"] == BKEY * kD // 16
    k_seen, raw = set(), set()
    for tid in range(threads):
        for i in range(L["kUnitsK"]):
            u = tid + i * threads
            r, c = u // (kD // 4), 4 * (u % (kD // 4))
            k_seen.update((r, c + j) for j in range(4))
            raw.add(4 * u)
    assert len(k_seen) == BKEY * kD and len(raw) == BKEY * kD // 4
    order = _p_key_order()
    v_seen = set()
    for tid in range(threads):
        for i in range(L["kItersV"]):
            u = tid + i * threads
            if u >= L["kUnitsV"]:
                continue
            jp, c = u % 16, 4 * (u // 16)
            col = 8 * (jp >> 1) + 4 * (jp & 1)
            for m in range(4):
                key = 8 * (jp >> 1) + (jp & 1) + 2 * m
                assert order[col + m] == key
                v_seen.update((key, c + j) for j in range(4))
    assert len(v_seen) == BKEY * kD


def _p_key_order() -> list:
    """The key P's A fragment takes at each k position of a 64-key step:
    k t <-> key 2 t and k t + 4 <-> key 2 t + 1 within each 8."""
    return [8 * (p // 8) + (2 * (p % 8) if p % 8 < 4 else 2 * (p % 8 - 4) + 1)
            for p in range(BKEY)]


def test_p_and_v_orders_in_the_source():
    """The source loads V's units, stores them transposed and splits P into
    its fragments by the rules the emulation below takes."""
    src = _source()
    for text in ("const int s = s0 + 8 * (jp >> 1) + (jp & 1) + 2 * m;",
                 "col = 8 * (jp >> 1) + 4 * (jp & 1);",
                 "store_split(Vh, Vl, usk::sw_tf32(c, col, kD), make_float4(x[0].x, x[1].x, x[2].x, x[3].x));",
                 "usk::split_tf32(pe[0], ph[n][0], pl[n][0]);  // (g, key 2 tq)",
                 "usk::split_tf32(pe[1], ph[n][2], pl[n][2]);  // (g, key 2 tq + 1)",
                 "for (int kk = 0; kk < kD / 8; ++kk) {",
                 "wgmma_pv(ost, pl[j], dvh, j > 0);"):
        assert text in src, text
    order = _p_key_order()
    assert sorted(order) == list(range(BKEY))
    assert all(order[p] // 8 == p // 8 for p in range(BKEY))


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


def _emulate(q, k, v, bias, gate, kpm, amask, rate, seed, skip=True):
    """The width-80 / width-96 forward's dataflow in plain torch: per
    (utterance, head, 64-query tile) the open key tiles in order (every
    tile where ``skip`` is off), S per 8-column k step, the online softmax,
    P.V. Returns (out, lse, the key tiles each utterance ran)."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    kD = fa.f32_width(hd)
    qk, kscale = fa.kernel_q(q)
    pad = lambda x: torch.nn.functional.pad(x, (0, kD - hd))  # noqa: E731
    qp, kp, vp = pad(qk), pad(k), pad(v)
    c_all = fa._keep_scale(q, k, rate, seed)
    order = _p_key_order()
    n_tiles = -(-S // BKEY)
    out, lse = torch.zeros(B, T, H, hd), torch.zeros(B, H, T)
    runs = {}
    for b in range(B):
        masked = skip and kpm is not None and amask is None and bool((~kpm[b]).any())
        tiles = [j for j in range(n_tiles)
                 if not (masked and bool(kpm[b, BKEY * j:BKEY * j + BKEY].all()))]
        runs[b] = tiles
        for h in range(H):
            for t0 in range(0, T, BQ):
                mq = min(BQ, T - t0)
                rows = slice(t0, t0 + mq)
                Q = torch.zeros(BQ, kD)
                Q[:mq] = qp[b, rows, h]
                O, l = torch.zeros(BQ, kD), torch.zeros(BQ)
                m = torch.full((BQ,), -math.inf)
                for j in tiles:
                    s0 = BKEY * j
                    n = min(BKEY, S - s0)
                    keys = slice(s0, s0 + n)
                    K, V = torch.zeros(BKEY, kD), torch.zeros(BKEY, kD)
                    K[:n], V[:n] = kp[b, keys, h], vp[b, keys, h]
                    sacc = None  # a fresh sum per k step, added in fp32
                    for kk in range(kD // 8):
                        cs = slice(8 * kk, 8 * kk + 8)
                        t = _prod3(Q[:, cs], K[:, cs].t())
                        sacc = t if sacc is None else sacc + t
                    x = sacc * kscale
                    if bias is not None:
                        g = gate[b, h, rows] if gate is not None else torch.ones(mq)
                        x[:mq, :n] = x[:mq, :n] + g[:, None] * bias[h, rows, keys]
                    if amask is not None:
                        x[:mq, :n] = x[:mq, :n] + amask[rows, keys]
                    colneg = torch.full((BKEY,), -math.inf)
                    colneg[:n] = 0.0 if kpm is None else torch.where(kpm[b, keys], PAD_NEG, 0.0)
                    x = x + colneg[None, :]
                    m_new = torch.maximum(m, x.amax(1))
                    alpha = torch.exp2((m - m_new) * LOG2E)
                    p = torch.exp2((x - m_new[:, None]) * LOG2E)
                    l = l * alpha + p.sum(1)
                    if c_all is not None:
                        cc = torch.zeros(BQ, BKEY)
                        cc[:mq, :n] = c_all[b, h, rows, keys]
                        p = p * cc
                    # P's k positions permuted within each 8 keys, V^T's keys stored so
                    O = O * alpha[:, None] + _prod3(p[:, order], V[order])
                    m = m_new
                out[b, rows, h] = (O / l[:, None])[:mq, :hd]
                lse[b, h, rows] = (m + torch.log(l))[:mq]
    return out, lse, runs


FORMS = {  # name: (gated bias, (T, S) band mask, dropout rate)
    "kpm_drop": (False, False, 0.1),
    "bias_gate_kpm": (True, False, 0.0),
    "kpm_band_mask": (False, True, 0.0),
}


def _inputs(hd, form):
    """B = 4 rows of T = S = 150 frames (three key tiles, three query
    tiles): lengths 150, 60 (its last two tiles all padded), 0, and a row
    whose first 70 keys are padded (its first tile: a mask that is not a
    suffix)."""
    with_bias, band, rate = FORMS[form]
    B, T, H = 4, 150, 2
    rng = np.random.RandomState(hd + 7 * len(form))
    q, k, v = (torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32)) for _ in range(3))
    kpm = torch.arange(T)[None, :] >= torch.tensor([150, 60, 0, 150])[:, None]
    kpm[3, :70] = True
    bias = gate = amask = None
    if with_bias:
        bias = torch.from_numpy(rng.randn(H, T, T).astype(np.float32))
        gate = torch.from_numpy(rng.rand(B, H, T).astype(np.float32) * 2 + 1)
    if band:
        idx = torch.arange(T)
        amask = torch.where((idx[:, None] - idx[None, :]).abs() > 40, -1e4, 0.0)
    seed = torch.tensor([hd], dtype=torch.int64) if rate > 0 else None
    return q, k, v, bias, gate, kpm, amask, rate, seed


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _row_kinds(kpm, amask):
    """(B, T) masks of the query rows with an open key that the (T, S) mask
    leaves at 0, and of those whose open keys all sit behind it."""
    open_keys = ~kpm[:, None, :]  # (B, 1, S)
    has_key = open_keys.any(-1).expand(-1, kpm.shape[1] if amask is None else amask.shape[0])
    if amask is None:
        return has_key, torch.zeros_like(has_key)
    in_band = (open_keys & (amask == 0)[None]).any(-1)
    return in_band, has_key & ~in_band


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_emulated_layout_matches_the_plain_forward(hd, form):
    """The emulated dataflow against the plain forward: out within relative
    L2 1e-5 (2^-10 on the rows whose open keys all sit behind the band
    mask), lse within 1e-4 plus 2 fp32 ulps on the rows with a key, the
    row of length 0 the mean of v on both sides where there is no
    dropout."""
    args = _inputs(hd, form)
    got, got_lse, _ = _emulate(*args)
    want, want_lse = fa.fused_attention_plain(*args[:7], dropout_rate=args[7],
                                              dropout_seed=args[8], return_lse=True)
    in_band, behind = _row_kinds(args[5], args[6])
    assert _rel(got[in_band], want[in_band]) <= 1e-5
    if behind.any():
        assert _rel(got[behind], want[behind]) <= BEHIND_MASK_TOL
    valid = torch.tensor([True, True, False, True])
    err = (got_lse[valid] - want_lse[valid]).abs() - 2 * 2.0 ** -23 * want_lse[valid].abs()
    assert err.max().item() <= 1e-4
    if args[7] == 0.0:
        mean = args[2][2].mean(0, keepdim=True).expand_as(got[2])
        assert _rel(got[2], mean) <= 1e-5 and _rel(want[2], mean) <= 1e-5


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("form", ["bias_gate_kpm", "kpm_band_mask"])
def test_emulated_layout_matches_pallas(hd, form):
    """The emulated dataflow against JAX's fused_attention through the
    Pallas kernel in interpret mode (no dropout: the two packages draw
    other masks; 2^-10 on the rows whose open keys all sit behind the band
    mask); the row of length 0 against the mean of v."""
    q, k, v, bias, gate, kpm, amask, rate, seed = _inputs(hd, form)
    got, _, _ = _emulate(q, k, v, bias, gate, kpm, amask, rate, seed)
    opt = {n: jnp.asarray(t.numpy()) for n, t in (("bias", bias), ("gate", gate),
                                                  ("attn_mask", amask)) if t is not None}
    want = np.asarray(jax_fused(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                key_padding_mask=jnp.asarray(kpm.numpy()), interpret=True, **opt))
    in_band, behind = (x.numpy() for x in _row_kinds(kpm, amask))
    np.testing.assert_allclose(got.numpy()[in_band], want[in_band], rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got.numpy()[behind], want[behind], rtol=BEHIND_MASK_TOL,
                               atol=BEHIND_MASK_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(v[2].mean(0), got[2].shape),
                               rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_padded_tile_skip_changes_nothing(form):
    """The tiles each row runs: all three in the full row and the row of
    length 0, the first in the row of length 60, the last two in the row
    padded at its start; every tile with a (T, S) mask. Skipping leaves
    out and lse bit for bit as running every tile: a skipped tile's p is
    exactly 0, and the tile before the first open key is erased by that
    key's rescale by 0."""
    args = _inputs(80, form)
    out, lse, runs = _emulate(*args)
    every = _emulate(*args, skip=False)
    if form == "kpm_band_mask":
        assert runs == {0: [0, 1, 2], 1: [0, 1, 2], 2: [0, 1, 2], 3: [0, 1, 2]}
    else:
        assert runs == {0: [0, 1, 2], 1: [0], 2: [0, 1, 2], 3: [1, 2]}
    assert every[2] == {b: [0, 1, 2] for b in range(4)}
    assert torch.equal(out, every[0]) and torch.equal(lse, every[1])


def test_skip_needs_an_open_key():
    """In a row of length 0 every key is as padded as the rest: p is
    uniform, so a tile whose keys are all padded adds to out there, and the
    kernel skips such tiles only in a row with an open key; the source
    decides so."""
    src = (CSRC / "flash_attention_f32_mid.cu").read_text()
    assert "const bool masked = a.kpm != nullptr && a.amask == nullptr;" in src
    assert "const bool skip = __syncthreads_or(row_open) != 0;" in src
    q, k, v, bias, gate, kpm, amask, rate, seed = _inputs(80, "kpm_drop")
    first = fa.fused_attention_plain(q, k[:, :64], v[:, :64], key_padding_mask=kpm[:, :64])
    whole = fa.fused_attention_plain(q, k, v, key_padding_mask=kpm)
    assert _rel(whole[2], first[2]) > 1e-2  # the row of length 0 sees every tile
    assert _rel(whole[1], first[1]) <= 1e-6  # the row of length 60 only its first


def test_bench_variants_apply_to_the_source():
    """Each variant that ``bench_attention_forward.py --variants`` builds
    finds the text it replaces in the source (one occurrence) and changes
    it."""
    from unispeech_tpu_torch.scripts import bench_attention_forward as bench

    src = (CSRC / bench.MID_SOURCE).read_text()
    for name, reps in bench.VARIANTS.items():
        for old, new in reps:
            assert src.count(old) == 1 and old != new, name
