"""The fp32 attention forward's width-128 form, on the CPU.

The kernel (``csrc/flash_attention_f32_wide.cu``, launched by
``csrc/flash_attention_f32.cu``'s entry, their shared pieces in
``flash_attention_f32.cuh``) runs only on the card. These tests hold what
its host side and its layout decide, at head dims 104, 112, 120 (XLS-R
2B's) and 128:
- the dispatch: hd 104-128 go to the form (``launch_wide``), whose kernel's
  name starts with ``flash_fwd_f32`` (the benchmark's device-time filter);
- the form's shared memory (its formulas read from the source) within a
  block's 227 KB, its swizzled tiles 1024-byte aligned; the threads'
  16-byte units covering each key tile's K and V once, K's and V's units
  of a thread filling the same slots of the one raw buffer (so each thread
  splits only what it copied), V^T's keys stored in the order P's
  fragments take them;
- the dataflow, emulated in plain torch at the kernel's tiles (64 queries,
  64-key steps): each tile's K and then its V through the raw buffer by
  thread slot, q, K, P and V^T split into TF32 hi + lo (cvt.rna: q split
  per k step in registers gives the hi and lo a split tile holds), S as
  three products per 8-column k step into a fresh sum added in fp32, P.V
  with P's k order permuted, the online softmax in
  natural units with ex2, and the all-padded key tiles skipped (in a row
  with an open key and without a (T, S) mask); against
  ``fused_attention_plain`` (relative L2 1e-5; lse within 1e-4 plus 2 fp32
  ulps on the rows with a key) and JAX's ``fused_attention`` through the
  Pallas kernel in interpret mode (rtol and atol 2e-5). The rows whose open
  keys all sit behind the -1e4 band mask are held to 2^-10 (one fp32 ulp
  there, ``test_torch_attn_fwd_f32_mid_layout.py`` says why), the row of
  length 0 to the mean of v, skip against no skip bit for bit.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_attn_fwd_f32_mid_layout import (
    ATTN_TOL,
    BEHIND_MASK_TOL,
    BKEY,
    BQ,
    FORMS,
    LOG2E,
    PAD_NEG,
    _inputs,
    _p_key_order,
    _prod3,
    _rel,
    _row_kinds,
)
from unispeech_tpu.ops.pallas.flash_attention import fused_attention as jax_fused
from unispeech_tpu_torch.ops.kernels import flash_attention as fa
from unispeech_tpu_torch.scripts import bench_attention_forward as bench

CSRC = pathlib.Path(fa.__file__).resolve().parents[2] / "csrc"
WIDE = CSRC / "flash_attention_f32_wide.cu"
HDS = [104, 112, 120, 128]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eval(expr: str, env: dict) -> int:
    """A C integer expression of the source in Python (integer division,
    ``a ? b : c`` in parentheses)."""
    expr = expr.replace("(int)", "").replace("/", "//")
    expr = re.sub(r"\(([^()?]+) \? ([^():]+) : ([^()]+)\)", r"(\2 if \1 else \3)", expr)
    return int(eval(expr, {}, dict(env)))


def _layout() -> dict:
    """WideLayout's members and the constants they use, from the source."""
    text = (CSRC / "flash_attention_f32.cuh").read_text() + WIDE.read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr (?:int|uint32_t) (k\w+) = ([^;]+);", text, re.M):
        try:
            env[name] = _eval(expr, env)
        except Exception:  # float constants and the like
            pass
    body = re.search(r"struct WideLayout \{(.*?)\n\};", text, re.S).group(1)
    for name, expr in re.findall(r"static constexpr (?:int|uint32_t) (k\w+) = ([^;]+);", body):
        env[name] = _eval(expr, env)
    return env


@pytest.mark.parametrize("hd", HDS)
def test_dispatch_sends_wide_heads_to_the_form(hd):
    """hd 104-128 (above kMidMaxHd) run the width-128 form: the entry's
    last branch launches it, ``f32_width`` says 128, and its kernel is
    named so that the benchmark's device-time filter counts it."""
    entry = (CSRC / "flash_attention_f32.cu").read_text()
    wide = WIDE.read_text()
    L = _layout()
    assert "if (hd <= kMidMaxHd) return (int)launch_mid<96>(a, B, s);\n" \
           "    return (int)launch_wide(a, B, s);" in entry
    assert "flash_fwd_f32_kernel<128" not in entry and "launch_width<128>" not in entry
    assert L["kMidMaxHd"] < hd <= L["kMaxHd"] == L["kD"]
    assert fa.f32_width(hd) == 128 and fa.kernel_head_dim(hd) == hd
    assert "flash_fwd_f32_wide_kernel(Args a)" in wide
    assert "flash_fwd_f32" in "flash_fwd_f32_wide_kernel"
    assert bench.WIDE_SOURCE == WIDE.name and WIDE.name in bench.F32_SOURCES


def test_wide_layout_fits_and_aligns():
    """q (two warpgroups' 128 rows in fp32, 64 KB), K and V^T split (64 KB
    each) and the 32 KB raw buffer fit a block with the key mask, the
    open-tile bits and 1 KB of alignment; the wgmma tiles start on
    1024-byte boundaries; the buffer holds one 64-key tile of 128 fp32
    columns in 16-byte units."""
    L = _layout()
    assert L["kWG"] == 2
    assert L["kSmem"] == 229888 + 1024 <= L["kSmemMax"] == 232448
    assert L["kQTile"] == 65536 and L["kKTile"] == L["kVTile"] == 32768
    for name in ("kQTile", "kKTile", "kVTile", "kOffK", "kOffV", "kOffRaw"):
        assert L[name] % 1024 == 0, name
    assert L["kOffK"] == 65536 and L["kOffV"] == L["kOffK"] + 2 * L["kKTile"]
    assert L["kOffCol"] - L["kOffRaw"] == BKEY * 128 * 4
    assert L["kOffTiles"] == L["kOffCol"] + BKEY * 4
    assert L["kBQ"] == 2 * BQ and L["kThreads"] == 256 and L["kBKey"] == BKEY


def _units(L):
    """Per thread: its K units (slot, key, column) and V units (slot, key,
    column, V^T column), as issue_k / issue_v copy and split_k / split_v
    store them."""
    kD, threads = L["kD"], L["kThreads"]
    k_units, v_units = {}, {}
    for tid in range(threads):
        k_units[tid] = []
        for i in range(L["kUnitsK"]):
            u = tid + i * threads
            k_units[tid].append((i, u // (kD // 4), 4 * (u % (kD // 4))))
        v_units[tid] = []
        for i in range(L["kItersV"]):
            u = tid + i * threads
            jp, c = u % 16, 4 * (u // 16)
            col = 8 * (jp >> 1) + 4 * (jp & 1)
            for m in range(4):
                key = 8 * (jp >> 1) + (jp & 1) + 2 * m
                v_units[tid].append((L["kItersV"] * m + i, key, c, col + m))
    return k_units, v_units


def test_units_cover_each_tile_once():
    """K's units cover 64 keys x 128 columns once and V's once; each thread
    fills the same kSlots slots of the raw buffer with its K units and then
    with its V units (no slot of another thread), so the split of its K
    frees exactly the slots its V copies land in; V^T column p holds the key
    P's fragment takes at k position p."""
    L = _layout()
    k_units, v_units = _units(L)
    order = _p_key_order()
    k_seen, v_seen = set(), set()
    for tid in range(L["kThreads"]):
        k_slots = [s for s, _, _ in k_units[tid]]
        v_slots = [s for s, _, _, _ in v_units[tid]]
        assert sorted(k_slots) == sorted(v_slots) == list(range(L["kSlots"]))
        for _, r, c in k_units[tid]:
            k_seen.update((r, c + j) for j in range(4))
        for _, key, c, pos in v_units[tid]:
            assert order[pos] == key
            v_seen.update((key, c + j) for j in range(4))
    assert len(k_seen) == len(v_seen) == BKEY * 128
    src = WIDE.read_text()
    for text in ("auto slot = [&](int j) { return raw + L::kThreads * j + tid; };",
                 "usk::cp_async16(slot(L::kItersV * m + i),",
                 "for (int m = 0; m < 4; ++m) x[m] = *slot(L::kItersV * m + i);",
                 "store_split(Kh, Kl, usk::sw_tf32(r, c, kBKey), *slot(i));",
                 "const int s = s0 + 8 * (jp >> 1) + (jp & 1) + 2 * m;",
                 "col = 8 * (jp >> 1) + 4 * (jp & 1);",
                 "issue_v(nxt * kBKey);  // over this thread's slots, already split",
                 "if (nxt < n_tiles) issue_k(nxt * kBKey);  // over this thread's slots, already split",
                 "usk::wgmma_m64n64k8_rs_tf32(t[bf], ql[bf], dkh, 0);"):
        assert text in src, text


def _index(units):
    """The units as index tensors: K's (thread, slot, key, column unit) and
    V's (thread, slot, key, column unit, V^T column)."""
    k_units, v_units = units
    ki = torch.tensor([(t, s, r, c // 4) for t, us in k_units.items() for s, r, c in us])
    vi = torch.tensor([(t, s, key, c // 4, pos) for t, us in v_units.items()
                       for s, key, c, pos in us])
    return ki, vi


def _through_buffer(kt: torch.Tensor, vt: torch.Tensor, index):
    """A key tile's K (64, 128) and V (64, 128), as the copies give them
    (zeros past S and hd), through the raw buffer: K into each thread's
    slots and out into the K tile, then V into the same slots and out into
    V^T (128, 64) with its keys in P's k order."""
    ki, vi = index
    raw = torch.full((int(ki[:, 0].max()) + 1, int(ki[:, 1].max()) + 1, 4), math.nan)
    raw[ki[:, 0], ki[:, 1]] = kt.view(BKEY, -1, 4)[ki[:, 2], ki[:, 3]]
    K = torch.full((BKEY, kt.shape[1] // 4, 4), math.nan)
    K[ki[:, 2], ki[:, 3]] = raw[ki[:, 0], ki[:, 1]]
    raw[vi[:, 0], vi[:, 1]] = vt.view(BKEY, -1, 4)[vi[:, 2], vi[:, 3]]
    VT = torch.full((kt.shape[1] // 4, 4, BKEY), math.nan)
    VT[vi[:, 3], :, vi[:, 4]] = raw[vi[:, 0], vi[:, 1]]
    K, VT = K.reshape(BKEY, -1), VT.reshape(-1, BKEY)
    assert not (K.isnan().any() or VT.isnan().any())
    return K, VT


def _emulate(q, k, v, bias, gate, kpm, amask, rate, seed, skip=True):
    """The width-128 forward's dataflow in plain torch: per (utterance,
    head) each key tile through the raw buffer; per 64-query tile the open
    key tiles in order (every tile where ``skip`` is off), S per 8-column k
    step over the width, the online softmax, P.V. Returns (out, lse, the key tiles
    each utterance ran)."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    kD = fa.f32_width(hd)
    assert kD == 128
    index = _index(_units(_layout()))
    qk, kscale = fa.kernel_q(q)
    pad = lambda x: torch.nn.functional.pad(x, (0, kD - hd))  # noqa: E731
    qp, kp, vp = pad(qk), pad(k), pad(v)
    c_all = fa._keep_scale(q, k, rate, seed)
    n_tiles = -(-S // BKEY)
    out, lse = torch.zeros(B, T, H, hd), torch.zeros(B, H, T)
    runs = {}
    for b in range(B):
        masked = skip and kpm is not None and amask is None and bool((~kpm[b]).any())
        tiles = [j for j in range(n_tiles)
                 if not (masked and bool(kpm[b, BKEY * j:BKEY * j + BKEY].all()))]
        runs[b] = tiles
        for h in range(H):
            stage = {}
            for j in tiles:
                n = min(BKEY, S - BKEY * j)
                kt, vt = torch.zeros(BKEY, kD), torch.zeros(BKEY, kD)
                kt[:n], vt[:n] = kp[b, BKEY * j:BKEY * j + n, h], vp[b, BKEY * j:BKEY * j + n, h]
                stage[j] = _through_buffer(kt, vt, index)
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
                    K, VT = stage[j]
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
                    # P's k positions permuted within each 8 keys, as V^T stores them
                    O = O * alpha[:, None] + _prod3(p[:, _p_key_order()], VT.t())
                    m = m_new
                out[b, rows, h] = (O / l[:, None])[:mq, :hd]
                lse[b, h, rows] = (m + torch.log(l))[:mq]
    return out, lse, runs


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_emulated_wide_layout_matches_the_plain_forward(hd, form):
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
def test_emulated_wide_layout_matches_pallas(hd, form):
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
def test_wide_padded_tile_skip_changes_nothing(form):
    """The tiles each row runs at hd 120 (XLS-R 2B's): all three in the full
    row and the row of length 0, the first in the row of length 60, the
    last two in the row padded at its start; every tile with a (T, S) mask.
    Skipping leaves out and lse bit for bit as running every tile; the
    source skips as the width-80 / width-96 form does."""
    src = WIDE.read_text()
    assert "const bool masked = a.kpm != nullptr && a.amask == nullptr;" in src
    assert "const bool skip = __syncthreads_or(row_open) != 0;" in src
    args = _inputs(120, form)
    out, lse, runs = _emulate(*args)
    every = _emulate(*args, skip=False)
    if form == "kpm_band_mask":
        assert runs == {b: [0, 1, 2] for b in range(4)}
    else:
        assert runs == {0: [0, 1, 2], 1: [0], 2: [0, 1, 2], 3: [1, 2]}
    assert every[2] == {b: [0, 1, 2] for b in range(4)}
    assert torch.equal(out, every[0]) and torch.equal(lse, every[1])


def test_q_fragments_are_the_wgmma_a_layout():
    """Each warpgroup reads q's A fragment of k step kk from the fp32 tile
    in the 128-byte swizzle: lane (g, tq) rows g and g + 8 of its warp's 16,
    columns 8 kk + tq and + 4, in the order A[g][tq], A[g + 8][tq],
    A[g][tq + 4], A[g + 8][tq + 4]; the 32 lanes of a warp hit 32 distinct
    banks."""
    src = WIDE.read_text()
    for text in ("usk::split_tf32(qf[usk::sw_tf32(rq, c, L::kBQ) / 4], qh[bf][0], ql[bf][0]);",
                 "usk::split_tf32(qf[usk::sw_tf32(rq + 8, c, L::kBQ) / 4], qh[bf][1], ql[bf][1]);",
                 "usk::split_tf32(qf[usk::sw_tf32(rq, c + 4, L::kBQ) / 4], qh[bf][2], ql[bf][2]);",
                 "usk::split_tf32(qf[usk::sw_tf32(rq + 8, c + 4, L::kBQ) / 4], qh[bf][3], ql[bf][3]);",
                 "const int rq = 64 * wg + 16 * wq + g;",
                 "const int c = 8 * kk + tq;"):
        assert text in src, text

    def sw(r, col, rows=128):  # usk::sw_tf32
        return (col >> 5) * rows * 128 + r * 128 + ((((col & 31) >> 2) ^ (r & 7)) << 4) + (col & 3) * 4

    for kk in range(16):
        for wq in range(4):
            for e in range(4):  # the fragment's four registers
                banks = {sw(16 * wq + g + 8 * (e & 1), 8 * kk + tq + 4 * (e >> 1)) // 4 % 32
                         for g in range(8) for tq in range(4)}
                assert len(banks) == 32


def test_wide_bench_variants_apply_to_the_source():
    """Each variant of the width-128 form that ``bench_attention_forward.py
    --variants --shape xlsr2b`` builds finds the text it replaces in the
    source (one occurrence) and changes it."""
    src = WIDE.read_text()
    for name, reps in bench.WIDE_VARIANTS.items():
        for old, new in reps:
            assert src.count(old) == 1 and old != new, name
