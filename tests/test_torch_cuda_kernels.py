"""The port's CUDA kernels against their plain versions at edge shapes, on the
card (skipped without one). Run there with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``: the
repo's conftest imports JAX, which the port's machines need not have.

chip_smoke.py checks the kernels at the main path's shapes; these cases
cover what it does not reach: ragged and very short sequences, tiles cut by
t_out, T or C, odd T under the conv GEMM's even/odd row view, strided q/k/v
views, a bias without a gate, dropout, the micro-benchmark's ragged sizes,
the inputs each wrapper must reject, and the fp32 forward kernels (the
models' default dtype). Tolerance: one bf16 ulp at the tensor's
scale (two fp32 accumulation orders may round to neighbouring bf16 values);
attention 2 ulps (its online softmax rounds P against a running max).
Backward: bf16 outputs within 2 ulps at the tensor's scale (an operand
rounded to bf16 on either side of a boundary, then summed in another order);
fp32 sums (dW, da/db, dbias, dgate) within relative L2 1e-3 (the same
terms, fp32 atomics in a varying order, rare one-ulp flips of a bf16
operand). fp32 forward kernels: y1 rtol 1e-5 / atol 1e-6 (10 fp32 FMAs in
another order), its sums within 1e-5 of the sum of |terms|; the conv block
and attention relative L2 <= 1e-5 and max abs <= 1e-4 of max |plain|
(3xTF32 products: fp32 to a few ulps, summed in another order; one TF32
pass would miss by ~1e-3); lse within 1e-4 on rows with a key. fp32
backward kernels (and the fp32 dropout forward): the products (dq, dk, dv,
dx, out) as the fp32 forward; the sums taken by fp32 atomics in a
run-dependent order (dW of the L1 and the conv blocks, dbias, dgate, da,
db) within 1e-5 of the sum of |terms| per element.
"""

import pytest
import torch

from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend, vpu_micro
from unispeech_tpu_torch.ops.kernels.sum_terms import (
    SUM_RTOL,
    attn_terms,
    conv_terms,
    l1_terms,
    sum_error,
)

pytestmark = pytest.mark.cuda

ULP = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, ulps=1.0):
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ulps * ULP * want.float().abs().max().item(), err


def _rel(got, want, tol=1e-3):
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got.float() - want.float()).norm().item()
    assert diff <= tol * want.float().norm().item(), diff


# (B, t1, C) for the forward: the earlier cases' t1 (79, 999 and 9600 from
# 400, 5003 and 48,007 samples) and 9599; t1 one row either side of a
# tile's rows (32 and 64 at C = 512, 256 and 512 at C = 64, 32 above
# C = 1024); C = 192 (15 warps), 1024 and 2048 (two 64-channel blocks per
# warp); more tiles than SMs with several utterances (9600 x 2 at C = 512,
# 4097 x 5 at C = 1024), so a persistent block's warps flush their sums
# where they cross from one utterance to the next
L1_FWD_SHAPES = [(1, 79, 512), (3, 999, 64), (2, 9600, 512), (2, 9599, 512), (2, 31, 512),
                 (2, 33, 512), (2, 63, 512), (2, 65, 512), (1, 255, 64), (1, 257, 64),
                 (1, 511, 64), (1, 513, 64), (2, 333, 192), (5, 4097, 1024), (1, 15, 2048),
                 (2, 17, 2048), (3, 1001, 2048)]


@pytest.mark.parametrize("B,t1,C", L1_FWD_SHAPES)
@pytest.mark.parametrize("k,stride", [(10, 5), (8, 4), (16, 8)])
@pytest.mark.parametrize("stats", [True, False])
def test_l1_edges(dev, B, t1, C, k, stride, stats):
    """Both instantiations of the forward (with and without the sums) at
    WavLM's (10, 5) and, through the generic one, at (8, 4) and (16, 8): y1
    within one bf16 ulp, one launch, no sums without them. The sums: those
    of the y1 the kernel wrote within 1e-4 of the sum of |terms| (fp32 over
    t1 rows in two orders); the plain version's within 1e-4 of it at WavLM's
    (10, 5) from t1 = 79 on (the earlier cases), elsewhere within 1e-4 plus
    the sum of |y1 - y1_plain|: where the plain fp32 conv rounds y1 to the
    neighbouring bf16 value, its sums move by that much (a one-ulp flip is
    ~2^-8 / t1 of the sum, over 1e-4 of it at the shortest t1)."""
    g = torch.Generator().manual_seed(t1 * 3 + k + C)
    ns = (t1 - 1) * stride + k + t1 % stride  # a ragged tail of samples past the last window
    wav = (torch.randn(B, ns, generator=g) * 0.1).to(dev)
    w = (torch.randn(k, 1, C, generator=g) * 0.4).to(dev)
    before = l1_frontend.launches
    y, s1, s2, got_t1 = l1_frontend.l1_conv_with_stats(wav, w, stride, with_stats=stats)
    assert l1_frontend.launches == before + 1
    py, ps1, ps2, pt1 = l1_frontend.l1_conv_with_stats_plain(wav, w, stride)
    assert got_t1 == pt1 == t1
    _close(y, py)
    if not stats:
        assert s1 is None and s2 is None
        return
    yf, pyf = y.float(), py.float()
    for got, own, want, terms, flips in (
            (s1, yf.sum(1), ps1, yf.abs().sum(1), (yf - pyf).abs().sum(1)),
            (s2, yf.square().sum(1), ps2, yf.square().sum(1),
             (yf.square() - pyf.square()).abs().sum(1))):
        assert ((got - own).abs() <= 1e-4 * terms).all()
        strict = (k, stride) == (10, 5) and t1 >= 79
        assert ((got - want).abs() <= 1e-4 * terms + (0.0 if strict else flips)).all()


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("T,valid,C", [(9, 9, 128), (300, 257, 128), (1000, 1000, 512)])
@pytest.mark.parametrize("gelu_in,affine,gelu_out", [
    (True, True, True), (False, False, True), (True, False, False), (False, True, True)])
def test_conv_block_edges(dev, k, T, valid, C, gelu_in, affine, gelu_out):
    g = torch.Generator().manual_seed(T * 10 + k)
    x = torch.randn(2, T, C, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev, torch.bfloat16)
    ab = ((torch.rand(2, C, generator=g) + 0.5).to(dev),
          (torch.randn(2, C, generator=g) * 0.1).to(dev)) if affine else None
    y, t = conv_stack.conv_gelu_block(x, w, valid, gelu_in, gelu_out, ab)
    py, pt = conv_stack.conv_gelu_block_plain(x, w, valid, gelu_in, gelu_out, ab)
    assert t == pt == (valid - k) // 2 + 1
    _close(y, py)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("B,T,valid,C", [
    (3, 1001, 1001, 256),  # odd T: the last even row has no odd partner
    (2, 301, 300, 384),    # a 256-channel tile cut by C
    (2, 258, 258, 128),    # t_out = 128 (k = 3): exactly one row tile
    (4, 517, 515, 128),    # t_out one past a tile; rows past valid
])
@pytest.mark.parametrize("first", [True, False])
def test_conv_block_tiles(dev, k, B, T, valid, C, first):
    """The TMA/wgmma GEMM's edges: row tiles cut by t_out at every batch
    boundary, odd T under the even/odd row view, channel tiles cut by C; the
    first block with the affine + input GELU pass, the others without."""
    g = torch.Generator().manual_seed(T * 10 + k + C)
    x = torch.randn(B, T, C, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev, torch.bfloat16)
    ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
          (torch.randn(B, C, generator=g) * 0.1).to(dev)) if first else None
    y, t, pre = conv_stack._forward(x, w, valid, first, True, ab, want_pre=True)
    py, pt, ppre = conv_stack.conv_gelu_block_plain(x, w, valid, first, True, ab,
                                                    return_pre=True)
    assert t == pt == (valid - k) // 2 + 1
    _close(y, py)
    _close(pre, ppre)


# sizes with a scalar tail and a partial last block; one element either
# side of one block's 256 threads x 2 vectors (4,096 elements), of two
# blocks', of 132 x 8 blocks' (a wave at eight blocks per SM) and of the
# gelu+dgelu6 ring's 32 KB stage (16,384 elements)
VPU_SIZES = [8 * 256 * 3 + 5, 1_000_003, 7, 4095, 4097, 8191, 8193, 16383, 16385,
             132 * 8 * 4096 - 1, 132 * 8 * 4096 + 1]


@pytest.mark.parametrize("n", VPU_SIZES)
@pytest.mark.parametrize("variant", list(vpu_micro.VARIANTS))
@pytest.mark.parametrize("offset", [0, 8], ids=["base", "offset16B"])
def test_vpu_micro_ragged(dev, n, variant, offset):
    """Each micro-benchmark variant against its plain version, on sizes that
    leave a scalar tail and a partial last block, from the start of a buffer
    or 16 bytes into one (the fp32 arithmetic is the same; exp may differ in
    the last fp32 bit: one bf16 ulp)."""
    g = torch.Generator().manual_seed(n)
    buf = (torch.randn(n + offset + 5, generator=g) * 3).to(dev, torch.bfloat16)
    x = buf[offset:offset + n]
    before = vpu_micro.launches
    got = vpu_micro.run(variant, x)
    assert vpu_micro.launches == before + 1
    want = vpu_micro.run_plain(variant, x)
    assert got.shape == want.shape and torch.isfinite(got).all()
    mag = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert ((got.float() - want.float()).abs() <= ulp).all()


def _attn_inputs(dev, B, T, H, seed, fused_qkv=False, hd=64):
    g = torch.Generator().manual_seed(seed)
    if fused_qkv:  # q/k/v as strided views of one (B, T, 3, H, hd) projection
        qkv = torch.randn(B, T, 3, H, hd, generator=g).to(dev, torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, T, H, hd, generator=g).to(dev, torch.bfloat16)
                   for _ in range(3))
    bias = torch.randn(H, T, T, generator=g).to(dev, torch.bfloat16)
    gate = (torch.rand(B, H, T, generator=g) * 2 + 1).to(dev)
    lengths = torch.tensor([T - (i * T) // (2 * B) for i in range(B)], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
    return q, k, v, bias, gate, kpm


# every template-flag combination of the forward kernel the wrappers reach:
# {no bias, bias, gated bias} x key padding x (T, S) mask x dropout; then
# q/k/v as views of one fused projection, and the rel-pos bias as
# compute_rel_pos_bias's view of rows padded to 8 keys
FWD_CASES = [b + "+kpm" * p + "+mask" * m + "+drop" * d
             for b in ("none", "bias", "gate") for p in (0, 1) for m in (0, 1) for d in (0, 1)]
FWD_CASES += ["strided", "bias_view"]


@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (2, 63, 2), (3, 65, 4), (2, 200, 12),
                                   (1, 799, 12)])
@pytest.mark.parametrize("case", FWD_CASES)
def test_attention_edges(dev, B, T, H, case):
    """The forward kernel against its plain version, out within 2 bf16 ulps
    (dropout: the same Philox mask on both sides), lse within 1e-3."""
    q, k, v, bias, gate, kpm = _attn_inputs(dev, B, T, H, seed=T * 7 + H,
                                            fused_qkv=case == "strided")
    kw = dict(bias=bias, gate=gate, key_padding_mask=kpm)
    if case == "bias_view":
        from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

        table = torch.randn(320, H, generator=torch.Generator().manual_seed(T)).to(dev)
        kw["bias"] = compute_rel_pos_bias(table, T, T, 320, 800, dtype=torch.bfloat16)
        assert kw["bias"].stride(1) == -(-T // 8) * 8
    elif case != "strided":
        parts = case.split("+")
        if parts[0] == "none":
            kw = dict(bias=None, gate=None)
        elif parts[0] == "bias":
            kw["gate"] = None
        kw["key_padding_mask"] = kpm if "kpm" in parts else None
        if "mask" in parts:
            idx = torch.arange(T, device=dev)
            kw["attn_mask"] = torch.where((idx[:, None] - idx[None, :]).abs() > 20, -1e4, 0.0)
        if "drop" in parts:
            kw["dropout_rate"] = 0.1
            kw["dropout_seed"] = torch.tensor([T * 1000 + 17 + H], dtype=torch.int64, device=dev)
    before = flash_attention.launches
    out, lse = flash_attention.fused_attention(q, k, v, **kw, return_lse=True)
    assert flash_attention.launches == before + 1
    pout, plse = flash_attention.fused_attention_plain(q, k, v, **kw, return_lse=True)
    _close(out, pout, ulps=2.0)
    assert (lse - plse).abs().max().item() <= 1e-3


# head dims: multiples of 8 on either side of the 64-wide box (one box, two
# boxes of which the second is partly or wholly past hd), hd 80 (HuBERT
# X-Large, XLS-R 1B), 120 (XLS-R 2B), 128 (two whole boxes), and 36 and 100,
# which the wrapper runs on a copy zero-padded to 40 and 104
HEAD_DIMS = [8, 16, 24, 32, 36, 48, 72, 80, 100, 120, 128]
HD_FWD_CASES = ["gate+kpm", "none+kpm+drop", "bias+mask", "gate+kpm+mask+drop", "strided"]


def _hd_kwargs(dev, case, T, H, bias, gate, kpm):
    kw = dict(bias=bias, gate=gate, key_padding_mask=kpm)
    if case == "strided":
        return kw
    parts = case.split("+")
    if parts[0] == "none":
        kw = dict(bias=None, gate=None)
    elif parts[0] == "bias":
        kw["gate"] = None
    kw["key_padding_mask"] = kpm if "kpm" in parts else None
    if "mask" in parts:
        idx = torch.arange(T, device=dev)
        kw["attn_mask"] = torch.where((idx[:, None] - idx[None, :]).abs() > 20, -1e4, 0.0)
    if "drop" in parts:
        kw["dropout_rate"] = 0.1
        kw["dropout_seed"] = torch.tensor([T * 1000 + 29 + H], dtype=torch.int64, device=dev)
    return kw


@pytest.mark.parametrize("B,T,H", [(2, 65, 2), (1, 200, 3)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("case", HD_FWD_CASES)
def test_attention_head_dims(dev, B, T, H, hd, case):
    """The forward kernel at head dims other than 64 against its plain
    version (q pre-scaled in bf16 where the scale is not a power of two):
    out within 2 bf16 ulps, lse within 1e-3, one launch."""
    q, k, v, bias, gate, kpm = _attn_inputs(dev, B, T, H, seed=T * 11 + hd,
                                            fused_qkv=case == "strided", hd=hd)
    kw = _hd_kwargs(dev, case, T, H, bias, gate, kpm)
    before = flash_attention.launches
    out, lse = flash_attention.fused_attention(q, k, v, **kw, return_lse=True)
    assert flash_attention.launches == before + 1
    pout, plse = flash_attention.fused_attention_plain(q, k, v, **kw, return_lse=True)
    _close(out, pout, ulps=2.0)
    assert (lse - plse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,T,H", [(2, 65, 2), (1, 200, 3)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("case", ["full", "no_bias", "dropout", "attn_mask", "strided"])
def test_attention_backward_head_dims(dev, B, T, H, hd, case):
    """The backward kernel at head dims other than 64 against its plain
    version: dq/dk/dv within 2 bf16 ulps, dbias/dgate relative L2 2e-3,
    two launches (the pre-pass and the kernel)."""
    q, k, v, bias, gate, kpm = _attn_inputs(dev, B, T, H, seed=T * 13 + hd,
                                            fused_qkv=case == "strided", hd=hd)
    kw = dict(bias=bias, gate=gate)
    amask, rate, seed = None, 0.0, None
    if case == "no_bias":
        kw = dict(bias=None, gate=None)
    elif case == "attn_mask":
        idx = torch.arange(T, device=dev)
        amask = torch.where((idx[:, None] - idx[None, :]).abs() > 20, -1e4, 0.0)
    elif case == "dropout":
        rate, seed = 0.1, torch.tensor([T * 1000 + 31], dtype=torch.int64, device=dev)
    out, lse = flash_attention.fused_attention_plain(q, k, v, **kw, key_padding_mask=kpm,
                                                     attn_mask=amask, dropout_rate=rate,
                                                     dropout_seed=seed, return_lse=True)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(T + hd)).to(
        dev, torch.bfloat16)
    args = (q, k, v, kw["bias"], kw["gate"], kpm, amask, rate, seed, out, lse, dout)
    before = flash_attention.backward_launches
    got = flash_attention.fused_attention_backward(*args)
    assert flash_attention.backward_launches == before + 2
    want = flash_attention.fused_attention_backward_plain(*args)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, ulps=2.0)
    for a, b in zip(got[3:], want[3:]):
        assert (a is None) == (b is None)
        if a is not None:
            _rel(a, b, tol=2e-3)


def test_wrappers_reject(dev):
    x = torch.zeros(1, 64, 128, device=dev, dtype=torch.float16)
    w = torch.zeros(3, 128, 128, device=dev)
    with pytest.raises(ValueError):  # fp16 input: the kernels compute in bf16 or fp32
        conv_stack.conv_gelu_block(x, w, 64)
    with pytest.raises(ValueError):  # 96 channels: not a multiple of 128
        conv_stack.conv_gelu_block(torch.zeros(1, 64, 96, device=dev, dtype=torch.bfloat16),
                                   torch.zeros(3, 96, 96, device=dev), 64)
    q = torch.zeros(1, 8, 2, 136, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 136: above the kernels' 128
        flash_attention.fused_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # dropout needs a 1-element int64 seed
        flash_attention.fused_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError):  # the L1 kernel takes an fp32 waveform
        l1_frontend.l1_conv_with_stats(torch.zeros(1, 400, device=dev, dtype=torch.bfloat16),
                                       torch.zeros(10, 1, 64, device=dev), 5)
    for C in (96, 2112):  # not a multiple of 64; more than 2048 channels
        for stats in (True, False):
            with pytest.raises(ValueError):
                l1_frontend.l1_conv_with_stats(torch.zeros(1, 400, device=dev),
                                               torch.zeros(10, 1, C, device=dev), 5,
                                               with_stats=stats)


@pytest.mark.parametrize("over", [{}, {"use_fused_l1": False}], ids=["fused", "plain_l1"])
def test_small_model_kernel_path_matches_plain(dev, monkeypatch, over):
    """A small WavLM (head dim 64) on the card: the kernel path against the
    same model with the three ops' plain versions (bf16 rounding carried
    through 2 layers: relative L2 well under 2e-2)."""
    from unispeech_tpu_torch.configs import WavLMModelConfig, base_encoder_config
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.wavlm import WavLM

    enc = base_encoder_config(
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_layers=((128, 10, 5),) + ((128, 3, 2),) * 2,
        conv_pos=16, conv_pos_groups=4, relative_position_embedding=True,
        gru_rel_pos=True, num_buckets=32, max_distance=64, **over)
    model = WavLM(WavLMModelConfig(encoder=enc), dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator().manual_seed(1)
    wav = (torch.randn(3, 6000, generator=g) * 0.1).to(dev)
    lengths = torch.tensor([6000, 4100, 2500], device=dev)
    counts = [m.launches for m in (l1_frontend, conv_stack, flash_attention)]
    got = model.extract_features(wav, lengths=lengths).x
    launched = [m.launches - c for m, c in zip((l1_frontend, conv_stack, flash_attention), counts)]
    # conv: two GEMMs and the first block's H pass
    assert launched == [0 if over else 1, 3, 2]
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    want = model.extract_features(wav, lengths=lengths).x
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 2e-2


@pytest.mark.parametrize("B,T,valid", [(2, 4001, 4001), (3, 1001, 998)])
@pytest.mark.parametrize("k", [2, 3])
def test_conv_block_layer_norm_form(dev, B, T, valid, k):
    """The block as the layer_norm extractor runs it (input GELU, no affine,
    no output GELU) through its autograd function: y within one bf16 ulp of
    the plain version; dx within 2 ulps and dW within relative L2 1e-3 of
    the plain backward; launches: the H pass and the GEMM forward, the H
    pass, dx and dW backward (no g pass without the output GELU)."""
    g = torch.Generator().manual_seed(T + k)
    C = 512
    x = torch.randn(B, T, C, generator=g).to(dev, torch.bfloat16).requires_grad_()
    # fp32 like the model's parameters: the gradient then comes back in fp32
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev).requires_grad_()
    f0, b0 = conv_stack.launches, conv_stack.backward_launches
    y, t_out = conv_stack.conv_gelu_block(x, w, valid, gelu_in=True, gelu_out=False)
    assert conv_stack.launches == f0 + 2
    with torch.no_grad():
        py, _ = conv_stack.conv_gelu_block_plain(x, w, valid, True, False, None)
    _close(y, py)
    dy = torch.randn(B, t_out, C, generator=g).to(dev, torch.bfloat16)
    y.backward(dy)
    assert conv_stack.backward_launches == b0 + 3
    with torch.no_grad():
        pdx, pdw, _, _ = conv_stack.conv_gelu_block_backward_plain(
            x, w, valid, True, False, None, dy, None)
    _close(x.grad, pdx, ulps=2.0)
    _rel(w.grad, pdw)


def test_small_large_style_model_kernel_path_matches_plain(dev, monkeypatch):
    """A small WavLM-Large-style model (layer_norm extractor, pre-LN,
    normalized input; head dim 64) on the card: launches per forward (L1
    without the sums 1; conv 2 per block: each block has the input GELU, so
    its H pass and its GEMM; attention 1 per layer) and the kernel path
    against the plain path (relative L2 well under 2e-2, as the Base-style
    test)."""
    from unispeech_tpu_torch.configs import WavLMModelConfig, large_encoder_config
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.wavlm import WavLM

    enc = large_encoder_config(
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_layers=((128, 10, 5),) + ((128, 3, 2),) * 2,
        conv_pos=16, conv_pos_groups=4, relative_position_embedding=True,
        gru_rel_pos=True, num_buckets=32, max_distance=64, dropout=0.0,
        attention_dropout=0.0)
    model = WavLM(WavLMModelConfig(encoder=enc), dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator().manual_seed(2)
    wav = (torch.randn(3, 6000, generator=g) * 0.1).to(dev)
    lengths = torch.tensor([6000, 4100, 2500], device=dev)
    mods = (l1_frontend, conv_stack, flash_attention)
    counts = [m.launches for m in mods]
    got = model.extract_features(wav, lengths=lengths).x
    assert [m.launches - c for m, c in zip(mods, counts)] == [1, 4, 2]
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    want = model.extract_features(wav, lengths=lengths).x
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 2e-2


# (B, t1, C): short, long and ragged; t1 one row before, on and one row
# after the end of a tile of the backward's ring (R = 32 rows at C = 512,
# each warp a 16-row chunk; R = 256 at C = 64); C = 1024 (one 16-row chunk
# per warp) and C = 192 (15 consumer warps, 80-row tiles)
L1_BWD_SHAPES = [(1, 79, 512), (3, 999, 64), (2, 9600, 512), (2, 95, 512), (2, 96, 512),
                 (2, 97, 512), (1, 255, 64), (1, 256, 64), (1, 257, 64), (1, 1000, 1024),
                 (2, 333, 192)]


@pytest.mark.parametrize("B,t1,C", L1_BWD_SHAPES)
@pytest.mark.parametrize("k,stride", [(10, 5), (5, 5), (8, 4), (16, 8)])
@pytest.mark.parametrize("stats", [True, False])
def test_l1_backward_edges(dev, B, t1, C, k, stride, stats):
    g = torch.Generator().manual_seed(t1 + k)
    ns = (t1 - 1) * stride + k + t1 % stride  # a ragged tail of samples past the last window
    wav = (torch.randn(B, ns, generator=g) * 0.1).to(dev)
    w = (torch.randn(k, 1, C, generator=g) * 0.4).to(dev)
    assert (ns - k) // stride + 1 == t1
    dy = torch.randn(B, t1, C, generator=g).to(dev, torch.bfloat16)
    ds1 = ds2 = None
    if stats:
        ds1 = (torch.randn(B, C, generator=g) * 1e-2).to(dev)
        ds2 = (torch.randn(B, C, generator=g) * 1e-2).to(dev)
    before = l1_frontend.backward_launches
    got = l1_frontend.l1_conv_backward(wav, w, stride, dy, ds1, ds2)
    assert l1_frontend.backward_launches == before + 1
    want = l1_frontend.l1_conv_backward_plain(wav, w, stride, dy, ds1, ds2)
    _rel(got, want)


def test_l1_backward_unaligned_views(dev):
    """A waveform and a dy that start 4 and 2 bytes into their buffers: the
    kernel reads both by TMA, which needs 16-byte aligned storage."""
    g = torch.Generator().manual_seed(7)
    B, t1, C, k, s = 2, 97, 512, 10, 5
    ns = (t1 - 1) * s + k
    wav = (torch.randn(B * ns + 1, generator=g) * 0.1).to(dev)[1:].view(B, ns)
    dy = torch.randn(B * t1 * C + 1, generator=g).to(dev, torch.bfloat16)[1:].view(B, t1, C)
    w = (torch.randn(k, 1, C, generator=g) * 0.4).to(dev)
    ds1 = (torch.randn(B, C, generator=g) * 1e-2).to(dev)
    ds2 = (torch.randn(B, C, generator=g) * 1e-2).to(dev)
    assert wav.data_ptr() % 16 and dy.data_ptr() % 16
    _rel(l1_frontend.l1_conv_backward(wav, w, s, dy, ds1, ds2),
         l1_frontend.l1_conv_backward_plain(wav, w, s, dy, ds1, ds2))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("B,T,valid,C", [
    (2, 9, 9, 128),         # t_out < one row tile; tap 2 at t' = 0 everywhere
    (2, 300, 257, 128),     # rows past valid; a 256-channel tile half out of C
    (2, 1000, 1000, 512),   # t_out not a multiple of the tile
    (1, 517, 515, 128),     # odd ts with valid < ts, one utterance
    (3, 1001, 998, 512),    # odd ts, three utterances: dW steps cross batch rows
])
@pytest.mark.parametrize("gelu_in,affine", [(True, True), (False, False), (True, False),
                                            (False, True)])
@pytest.mark.parametrize("gelu_out", [True, False])
def test_conv_backward_edges(dev, k, B, T, valid, C, gelu_in, affine, gelu_out):
    g = torch.Generator().manual_seed(T * 10 + k + 1)
    x = torch.randn(B, T, C, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev, torch.bfloat16)
    ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
          (torch.randn(B, C, generator=g) * 0.1).to(dev)) if affine else None
    t_out = (valid - k) // 2 + 1
    _, _, pre = conv_stack.conv_gelu_block_plain(x, w, valid, gelu_in, gelu_out, ab,
                                                 return_pre=True)
    dy = torch.randn(B, t_out, C, generator=g).to(dev, torch.bfloat16)
    got = conv_stack.conv_gelu_block_backward(x, w, valid, gelu_in, gelu_out, ab, dy, pre)
    want = conv_stack.conv_gelu_block_backward_plain(x, w, valid, gelu_in, gelu_out, ab,
                                                     dy, pre)
    _close(got[0], want[0], ulps=2.0)
    assert (got[0][:, valid:] == 0).all()
    _rel(got[1], want[1])
    if affine:
        _rel(got[2], want[2])
        _rel(got[3], want[3])
    # the forward writes the same pre-activation as the plain version
    y, _, kpre = conv_stack._forward(x, w, valid, gelu_in, gelu_out, ab, want_pre=True)
    _close(kpre, pre)


@pytest.mark.parametrize("parts", [0, conv_stack.BWD_DX, conv_stack.BWD_DW])
def test_conv_backward_parts(dev, parts):
    """A backward call that names one GEMM (or neither) launches the g and H
    passes and that GEMM alone, counts them, and writes what it launched as
    the full call does: chip_smoke.py times dx and dW apart this way."""
    g = torch.Generator().manual_seed(parts + 11)
    B, T, valid, C, k = 2, 300, 257, 128, 3
    x = torch.randn(B, T, C, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev, torch.bfloat16)
    ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
          (torch.randn(B, C, generator=g) * 0.1).to(dev))
    _, t_out, pre = conv_stack.conv_gelu_block_plain(x, w, valid, True, True, ab,
                                                     return_pre=True)
    dy = torch.randn(B, t_out, C, generator=g).to(dev, torch.bfloat16)
    args = (x, w, valid, True, True, ab, dy, pre)
    want = conv_stack.conv_gelu_block_backward_plain(*args)
    before = conv_stack.backward_launches
    got = conv_stack.backward_parts(*args, parts)
    torch.cuda.synchronize()
    assert conv_stack.backward_launches == before + 2 + (parts != 0)
    if parts & conv_stack.BWD_DX:
        _close(got[0], want[0], ulps=2.0)
        _rel(got[2], want[2])
        _rel(got[3], want[3])
    else:
        assert (got[2] == 0).all() and (got[3] == 0).all()
    if parts & conv_stack.BWD_DW:
        _rel(got[1], want[1])
    else:
        assert (got[1] == 0).all()


@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (2, 63, 2), (3, 65, 4), (2, 200, 12)])
@pytest.mark.parametrize("case", ["full", "bias_no_gate", "no_bias", "attn_mask", "strided",
                                  "dropout"])
def test_attention_backward_edges(dev, B, T, H, case):
    q, k, v, bias, gate, kpm = _attn_inputs(dev, B, T, H, seed=T * 7 + H + 1,
                                            fused_qkv=case == "strided")
    kw = dict(bias=bias, gate=gate, key_padding_mask=kpm)
    rate, seed = 0.0, None
    if case == "bias_no_gate":
        kw["gate"] = None
    elif case == "no_bias":
        kw = dict(key_padding_mask=kpm)
    elif case == "attn_mask":
        idx = torch.arange(T, device=dev)
        kw["attn_mask"] = torch.where((idx[:, None] - idx[None, :]).abs() > 20, -1e4, 0.0)
    elif case == "dropout":
        rate, seed = 0.1, torch.tensor([T * 1000 + 17], dtype=torch.int64, device=dev)
    out, lse = flash_attention.fused_attention_plain(q, k, v, **kw, dropout_rate=rate,
                                                     dropout_seed=seed, return_lse=True)
    if rate:  # the kernel's dropout forward against the plain version, same mask
        kout = flash_attention.fused_attention(q, k, v, **kw, dropout_rate=rate,
                                               dropout_seed=seed)
        _close(kout, out, ulps=2.0)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(T)).to(
        dev, torch.bfloat16)
    args = (q, k, v, kw.get("bias"), kw.get("gate"), kpm, kw.get("attn_mask"), rate, seed,
            out, lse, dout)
    got = flash_attention.fused_attention_backward(*args)
    want = flash_attention.fused_attention_backward_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        _close(a, b, ulps=2.0)
    for a, b in zip(got[3:], want[3:]):
        assert (a is None) == (b is None)
        if a is not None:
            _rel(a, b, tol=2e-3)


@pytest.mark.parametrize("T", [63, 128, 200])
@pytest.mark.parametrize("drop", [False, True])
def test_attention_fully_padded_rows(dev, T, drop):
    """Rows of length 0 (the fixed-shape batches' padding rows): every key
    padded. The forward is finite and, as the plain softmax, uniform over
    the S keys; the backward from each side's own forward is finite and
    agrees with the plain one, dO nonzero on the padded rows too. lse is
    compared on the rows with a valid key (a padded row's is the mask
    value, -1e30 in the plain version, -2^100 in the kernels). Both
    backwards are exact on a row of length 0 only when its dO is 0, as in
    training: its lse rounds to the mask value in fp32, so both recompute
    p = 1 there, not 1/S, and agree on dq, dk, dv S times too large."""
    B, H = 3, 4
    q, k, v, bias, gate, _ = _attn_inputs(dev, B, T, H, seed=T + 5)
    lengths = torch.tensor([T, 0, T // 3], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
    kw = dict(bias=bias, gate=gate, key_padding_mask=kpm)
    rate, seed = (0.1, torch.tensor([T * 31], dtype=torch.int64, device=dev)) if drop \
        else (0.0, None)
    out, lse = flash_attention.fused_attention(q, k, v, **kw, dropout_rate=rate,
                                               dropout_seed=seed, return_lse=True)
    pout, plse = flash_attention.fused_attention_plain(q, k, v, **kw, dropout_rate=rate,
                                                       dropout_seed=seed, return_lse=True)
    _close(out, pout, ulps=2.0)
    valid = lengths > 0
    assert (lse[valid] - plse[valid]).abs().max().item() <= 1e-3
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(T)).to(
        dev, torch.bfloat16)
    args = (q, k, v, bias, gate, kpm, None, rate, seed)
    got = flash_attention.fused_attention_backward(*args, out, lse, dout)
    want = flash_attention.fused_attention_backward_plain(*args, pout, plse, dout)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, ulps=2.0)
    for a, b in zip(got[3:], want[3:]):
        _rel(a, b, tol=2e-3)


def test_attention_dropout_mask_is_bit_identical(dev):
    """q = k = 0 makes every probability 1/S; with v the identity over keys,
    out[t, s] = keep(t, s) / (S (1 - rate)), so the kernel's nonzero pattern
    is its keep mask, held equal to the plain version's Philox mask."""
    from unispeech_tpu_torch.ops.kernels.philox import attention_keep

    B, T, H = 2, 64, 3
    q = torch.zeros(B, T, H, 64, device=dev, dtype=torch.bfloat16)
    v = torch.eye(64, device=dev, dtype=torch.bfloat16)[None, :, None, :].expand(
        B, T, H, 64).contiguous()
    seed = torch.tensor([987654321987], dtype=torch.int64, device=dev)
    out = flash_attention.fused_attention(q, q, v, dropout_rate=0.25, dropout_seed=seed)
    keep = attention_keep(seed, B, H, T, T, 0.25)  # (B, H, T, S)
    assert torch.equal(out.permute(0, 2, 1, 3) != 0, keep)


def test_small_model_train_step_kernel_path_matches_plain(dev, monkeypatch):
    """A small HubertPretrainModel (head dim 64) on the card: one masked
    forward + backward through the kernels against the same model with the
    three ops' plain forwards differentiated by autograd. Per parameter,
    |g - g_plain| <= 5e-2 |g_plain| + 1e-4 |global| (bf16 roundings at other
    places in 2 layers forward and back; the floor covers the k_proj bias,
    analytically zero)."""
    from unispeech_tpu_torch.configs import HubertPretrainConfig, MaskConfig, base_encoder_config
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    enc = base_encoder_config(
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_layers=((128, 10, 5),) + ((128, 3, 2),) * 2,
        conv_pos=16, conv_pos_groups=4, relative_position_embedding=True,
        gru_rel_pos=True, num_buckets=32, max_distance=64, dropout=0.0,
        attention_dropout=0.0, encoder_layerdrop=0.0, remat_layers=False)
    cfg = HubertPretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.65, mask_length=4),
                               num_classes=(17,), final_dim=32)
    model = HubertPretrainModel(cfg, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator().manual_seed(1)
    T = enc.num_frames(6000)
    batch = {"source": (torch.randn(3, 6000, generator=g) * 0.1).to(dev),
             "targets": torch.randint(0, 17, (3, T, 1), generator=g).to(dev),
             "lengths": torch.tensor([6000, 4100, 2500], device=dev),
             "boundary_mask": (torch.rand(3, T, generator=g) < 0.5).to(dev)}
    loss_fn = make_hubert_loss_fn(model, HubertCriterionConfig())

    def grads():
        model.zero_grad(set_to_none=True)
        loss, ss, _ = loss_fn(batch, torch.Generator(), 0)
        (loss / ss).backward()
        return [p.grad.float().clone() for p in model.parameters()]

    counts = [(m.launches, m.backward_launches) for m in (l1_frontend, conv_stack, flash_attention)]
    gk = grads()
    launched = [(m.launches - a, m.backward_launches - b)
                for m, (a, b) in zip((l1_frontend, conv_stack, flash_attention), counts)]
    # conv backward: (g pass, dx, dW) per block and the first block's H pass;
    # attention backward: the rows pre-pass and the kernel per layer
    assert launched == [(1, 1), (3, 7), (2, 4)]
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    gp = grads()
    total = torch.sqrt(sum((x * x).sum() for x in gp)).item()
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        assert torch.isfinite(a).all(), name
        assert (a - b).norm().item() <= 5e-2 * b.norm().item() + 1e-4 * total, name


def test_small_wav2vec2_train_kernel_path_matches_plain(dev, monkeypatch):
    """A small UniSpeech model (Wav2Vec2PretrainModel: no relative position
    bias, head dim 64, the frontend trained with feature_grad_mult 1.0, the
    CTC head with mtlalpha 0.5) on the card, on a padded batch with dropout
    0.1 and attention dropout 0.1: one step's gradients through the kernels
    against the same model with the three ops' plain versions, the same
    generator seed (so the same masks, dropout, negatives, Gumbel noise and
    replace mask). Per parameter |g - g_plain| <= 5e-2 |g_plain| + 1e-4
    |global|, as the HuBERT case above."""
    from unispeech_tpu_torch.configs import (
        GumbelVQConfig,
        MaskConfig,
        Wav2Vec2PretrainConfig,
        base_encoder_config,
    )
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
    from unispeech_tpu_torch.train.tasks import make_wav2vec2_loss_fn

    enc = base_encoder_config(
        encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
        encoder_attention_heads=2, conv_layers=((128, 10, 5),) + ((128, 3, 2),) * 2,
        conv_pos=16, conv_pos_groups=4, dropout=0.1, attention_dropout=0.1,
        encoder_layerdrop=0.0, remat_layers=False)
    cfg = Wav2Vec2PretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.65, mask_length=4),
                                 final_dim=32, num_negatives=10,
                                 quantizer=GumbelVQConfig(num_vars=16, vq_dim=32),
                                 transpose=True, ctc_vocab_size=12)
    model = Wav2Vec2PretrainModel(cfg, dtype=torch.bfloat16,
                                  generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator().manual_seed(1)
    batch = {"source": (torch.randn(3, 6000, generator=g) * 0.1).to(dev),
             "lengths": torch.tensor([6000, 4100, 2500], device=dev),
             "labels": torch.randint(1, 12, (3, 6), generator=g).to(dev),
             "label_lengths": torch.tensor([6, 4, 2], device=dev)}
    loss_fn = make_wav2vec2_loss_fn(model, mtlalpha=0.5)

    def grads():
        model.zero_grad(set_to_none=True)
        loss, ss, _ = loss_fn(batch, torch.Generator().manual_seed(5), 0)
        (loss / ss).backward()
        return [p.grad.float().clone() for p in model.parameters()]

    mods = (l1_frontend, conv_stack, flash_attention)
    counts = [(m.launches, m.backward_launches) for m in mods]
    gk = grads()
    launched = [(m.launches - a, m.backward_launches - b) for m, (a, b) in zip(mods, counts)]
    assert launched == [(1, 1), (3, 7), (2, 4)]
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    gp = grads()
    total = torch.sqrt(sum((x * x).sum() for x in gp)).item()
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        assert torch.isfinite(a).all(), name
        assert (a - b).norm().item() <= 5e-2 * b.norm().item() + 1e-4 * total, name


# ------------------------------------------------------------ fp32 forward


def _close_f32(got, want):
    """The fp32 products' gate: relative L2 <= 1e-5 and max abs <= 1e-4 of
    max |want|."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    diff = got - want.float()
    assert diff.norm().item() <= 1e-5 * want.float().norm().item()
    assert diff.abs().max().item() <= 1e-4 * want.float().abs().max().item()


def _sum_close(got, want, terms):
    """An fp32 sum taken by atomics in a run-dependent order: each element
    within SUM_RTOL (1e-5) of the sum of its terms' magnitudes."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = sum_error(got, want, terms)
    assert err <= SUM_RTOL, err


@pytest.mark.parametrize("B,t1,C", [(1, 79, 512), (3, 999, 64), (2, 9599, 512), (2, 65, 512),
                                    (2, 333, 192), (5, 4097, 1024), (2, 17, 2048)])
@pytest.mark.parametrize("k,stride", [(10, 5), (8, 4), (16, 8)])
@pytest.mark.parametrize("stats", [True, False])
def test_l1_fp32_edges(dev, B, t1, C, k, stride, stats):
    """The fp32 forward, with and without its sums: y1 fp32 within rtol 1e-5
    / atol 1e-6 of the plain fp32 conv, one launch; the sums within 1e-5 of
    the sum of |terms| of the plain version's."""
    g = torch.Generator().manual_seed(t1 * 3 + k + C)
    ns = (t1 - 1) * stride + k + t1 % stride
    wav = (torch.randn(B, ns, generator=g) * 0.1).to(dev)
    w = (torch.randn(k, 1, C, generator=g) * 0.4).to(dev)
    before = l1_frontend.launches
    y, s1, s2, got_t1 = l1_frontend.l1_conv_with_stats(wav, w, stride, dtype=torch.float32,
                                                       with_stats=stats)
    assert l1_frontend.launches == before + 1
    py, ps1, ps2, pt1 = l1_frontend.l1_conv_with_stats_plain(wav, w, stride, torch.float32)
    assert got_t1 == pt1 == t1 and y.dtype == torch.float32
    torch.testing.assert_close(y, py, rtol=1e-5, atol=1e-6)
    if not stats:
        assert s1 is None and s2 is None
        return
    for got, want, terms in ((s1, ps1, py.abs().sum(1)), (s2, ps2, py.square().sum(1))):
        assert ((got - want).abs() <= 1e-5 * terms).all()


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("B,T,valid,C", [(2, 9, 9, 128), (3, 1001, 998, 256), (2, 300, 257, 384),
                                         (4, 517, 515, 128), (1, 2000, 2000, 512),
                                         (2, 259, 259, 1024)])
@pytest.mark.parametrize("gelu_in,affine,gelu_out", [
    (True, True, True), (False, False, True), (True, False, False), (False, True, False)])
def test_conv_block_fp32_edges(dev, k, B, T, valid, C, gelu_in, affine, gelu_out):
    """The fp32 block (the H pass where there is one, then the 3xTF32 GEMM)
    against the plain fp32 conv: y and pre; launches 1 + the H pass; its
    backward through autograd launches the fp32 kernels (the g pass with
    the output GELU, the H pass with the affine or the input GELU, dx, dW)
    and matches the plain backward: dx as the products, dW / da / db within
    1e-5 of the sum of |terms|."""
    _check_conv_block_fp32(dev, k, B, T, valid, C, gelu_in, affine, gelu_out)


def _dw_split_crosses(dev, B, t_out, C, k):
    """Whether a split of the fp32 dW kernel's plan on this card holds steps
    of two utterances."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per, splits = conv_stack.dw_split_plan(B, t_out, C, k, sms)
    nkb = -(-t_out // conv_stack.DW_STEP_ROWS)
    return any(len({s // nkb for s in range(i * per, min((i + 1) * per, B * nkb))}) > 1
               for i in range(splits))


FEW_ROWS = 8  # valid rows under which da/db are held as products (every case above has more)

# the fp32 GEMMs' tiling edges (128 x 128 tiles; dx both parities per block;
# dW split-K over (utterance, 32-row) steps): (k, B, T, valid, C)
FP32_TILING_CASES = {
    "bt_below_64": (3, 2, 40, 40, 128),          # B t_out = 38: one partial tile, one dW step each
    "t_out_1": (3, 2, 3, 3, 256),                # a single output row; dx's rows 0-2 from one g row
    "t_out_1_k2": (2, 3, 2, 2, 128),
    "c384": (3, 2, 300, 300, 384),               # three channel tiles, no 256-wide one
    "k2_parity0_one_tap": (2, 2, 600, 597, 512),
    "valid_odd_last_even_row": (3, 2, 301, 299, 256),  # row valid - 1 = 298 of parity 0
    "k2_valid_odd": (2, 3, 130, 129, 128),
}


@pytest.mark.parametrize("case", sorted(FP32_TILING_CASES))
@pytest.mark.parametrize("gelu_in,affine,gelu_out", [
    (True, True, True), (False, False, True), (True, False, False)])
def test_conv_fp32_tiling_edges(dev, case, gelu_in, affine, gelu_out):
    """The redesigned fp32 GEMMs at their tiling's edges, in the block's
    three forms, to the gates and launch counts of the edge cases above.
    The backward takes the plain forward's pre, as its plain version does:
    over a few rows (t_out = 1) the sum rule cannot absorb g's response to
    pre's last bits near gelu''s zero (a 1e-6 relative change of pre moves
    dW by ~1e-4 of the sum of |terms| there)."""
    k, B, T, valid, C = FP32_TILING_CASES[case]
    _check_conv_block_fp32(dev, k, B, T, valid, C, gelu_in, affine, gelu_out, same_pre=True)


@pytest.mark.parametrize("k,first", [(3, True), (2, False)])
def test_conv_fp32_dw_split_across_utterances(dev, k, first):
    """A dW split whose steps run from one utterance into the next (the
    card's own plan; the shape is the first of a few whose plan does)."""
    B, C = 3, 128
    T = next(t for t in range(1000, 4000, 37)
             if _dw_split_crosses(dev, B, (t - 1 - k) // 2 + 1, C, k))
    _check_conv_block_fp32(dev, k, B, T, T - 1, C, first, first, True, same_pre=True)


def _check_conv_block_fp32(dev, k, B, T, valid, C, gelu_in, affine, gelu_out, same_pre=False):
    """The forward against the plain forward; the backward through autograd
    (from the kernel's own pre) or, with ``same_pre``, called on the plain
    forward's pre, against the plain backward from that pre."""
    g = torch.Generator().manual_seed(T * 10 + k + C)
    x = torch.randn(B, T, C, generator=g).to(dev)
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev)
    ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
          (torch.randn(B, C, generator=g) * 0.1).to(dev)) if affine else None
    before = conv_stack.launches
    y, t, pre = conv_stack._forward(x, w, valid, gelu_in, gelu_out, ab, want_pre=True)
    assert conv_stack.launches == before + 1 + (gelu_in or affine)
    py, pt, ppre = conv_stack.conv_gelu_block_plain(x, w, valid, gelu_in, gelu_out, ab,
                                                    return_pre=True)
    assert t == pt == (valid - k) // 2 + 1
    _close_f32(y, py)
    _close_f32(pre, ppre)
    dy = torch.randn(B, t, C, generator=g).to(dev)
    if same_pre:
        before = conv_stack.backward_launches
        dx, dw, da, db = conv_stack.conv_gelu_block_backward(x, w, valid, gelu_in, gelu_out, ab,
                                                             dy, ppre)
    else:
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        abg = None if ab is None else tuple(t.clone().requires_grad_() for t in ab)
        yg, _ = conv_stack.conv_gelu_block(xg, wg, valid, gelu_in, gelu_out, abg)
        before = conv_stack.backward_launches
        yg.backward(dy)
        dx, dw = xg.grad, wg.grad
        da, db = (None, None) if ab is None else (abg[0].grad, abg[1].grad)
    assert conv_stack.backward_launches == before + 2 + gelu_out + (gelu_in or affine)
    want = conv_stack.conv_gelu_block_backward_plain(x, w, valid, gelu_in, gelu_out, ab, dy,
                                                     ppre)
    _close_f32(dx, want[0])
    assert (dx[:, valid:] == 0).all()
    terms = conv_terms(x, w, valid, gelu_in, gelu_out, ab, dy, ppre, want[0])
    _sum_close(dw, want[1], terms[0])
    if affine and valid < FEW_ROWS:
        # da/db over so few rows are products, as dx: the sum rule counts dX^
        # as exact, and one element of it can cancel many-fold in its own sum
        # over the output channels (t_out = 1, k = 2 read 2.6e-5 of the
        # rule's |terms|)
        _close_f32(da, want[2])
        _close_f32(db, want[3])
    elif affine:
        _sum_close(da, want[2], terms[1])
        _sum_close(db, want[3], terms[2])


@pytest.mark.parametrize("parts", [conv_stack.BWD_DX, conv_stack.BWD_DW])
@pytest.mark.parametrize("first", [True, False])
def test_conv_backward_parts_fp32(dev, parts, first):
    """backward_parts in fp32 with one GEMM: the g pass, the H pass where
    there is one and that GEMM launch, and only its outputs are written."""
    g = torch.Generator().manual_seed(parts + 13 + first)
    B, T, valid, C, k = 2, 300, 257, 128, 3
    x = torch.randn(B, T, C, generator=g).to(dev)
    w = (torch.randn(k, C, C, generator=g) * (2.0 / (k * C)) ** 0.5).to(dev)
    ab = ((torch.rand(B, C, generator=g) + 0.5).to(dev),
          (torch.randn(B, C, generator=g) * 0.1).to(dev)) if first else None
    _, t_out, pre = conv_stack.conv_gelu_block_plain(x, w, valid, first, True, ab,
                                                     return_pre=True)
    dy = torch.randn(B, t_out, C, generator=g).to(dev)
    args = (x, w, valid, first, True, ab, dy, pre)
    want = conv_stack.conv_gelu_block_backward_plain(*args)
    terms = conv_terms(*args, want[0])
    before = conv_stack.backward_launches
    got = conv_stack.backward_parts(*args, parts)
    torch.cuda.synchronize()
    assert conv_stack.backward_launches == before + 2 + first
    if parts & conv_stack.BWD_DX:
        _close_f32(got[0], want[0])
        if first:
            _sum_close(got[2], want[2], terms[1])
            _sum_close(got[3], want[3], terms[2])
        assert (got[1] == 0).all()
    else:
        _sum_close(got[1], want[1], terms[0])
        if first:
            assert (got[2] == 0).all() and (got[3] == 0).all()


def _attn_fp32_inputs(dev, hd, B, T, H, case):
    """fp32 q, k, v (B, T, H, hd), the lengths (the last row 0 where B > 1)
    and the case's keyword inputs."""
    g = torch.Generator().manual_seed(T * 7 + H + hd)
    q, k, v = (torch.randn(B, T, H, hd, generator=g).to(dev) for _ in range(3))
    lengths = torch.tensor([T - (i * T) // (2 * B) for i in range(B)])
    if B > 1:
        lengths[-1] = 0
    lengths = lengths.to(dev)
    kw = {}
    if "kpm" in case or case == "bias_view":
        kw["key_padding_mask"] = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
    if "bias" in case or "gate" in case:
        kw["bias"] = torch.randn(H, T, T, generator=g).to(dev)
    if case == "bias_view":
        from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

        table = torch.randn(32, H, generator=g).to(dev)
        kw["bias"] = compute_rel_pos_bias(table, T, T, 32, 64, dtype=torch.float32)
    if "gate" in case or case == "bias_view":
        kw["gate"] = (torch.rand(B, H, T, generator=g) * 2 + 1).to(dev)
    if "mask" in case:
        kw["attn_mask"] = torch.where(
            (torch.arange(T)[:, None] - torch.arange(T)[None, :]).abs() > 40, -1e4, 0.0).to(dev)
    return q, k, v, lengths, kw


# 72 and 80 run the forward's and the backward's width-80 forms, 88 and 96
# their width-96 forms, 104, 112, 120 and 128 the width-128 ones
FP32_ATTN_HDS = [16, 24, 36, 64, 72, 80, 88, 96, 104, 112, 120, 128]
# T = S of 1, 63, 65, 129 and 799 cross the fp32 kernels' tiles: the forward's
# 64-key steps and 128-query blocks (64 at widths 96 and 128), the backward's 64-key
# blocks and 32-query steps (33 and 63 one row past and short of a step)
FP32_ATTN_SHAPES = [(1, 1, 1), (3, 65, 4), (2, 200, 3), (4, 799, 2), (2, 63, 3), (3, 129, 2),
                    (2, 33, 2)]
FP32_ATTN_CASES = ["gate+kpm", "bias+kpm+mask", "none", "bias_view"]


@pytest.mark.parametrize("hd", FP32_ATTN_HDS)
@pytest.mark.parametrize("B,T,H", FP32_ATTN_SHAPES)
@pytest.mark.parametrize("case", FP32_ATTN_CASES)
def test_attention_fp32_edges(dev, hd, B, T, H, case):
    """The fp32 forward against the plain fp32 version: out (relative L2
    1e-5, max abs 1e-4 of max |plain|), lse within 1e-4 on rows with a key
    (plus 2 fp32 ulps of |lse|: a row whose unmasked keys are all padded
    has an lse near the mask's -1e4, where one ulp is 1e-3), one launch;
    the last row of length 0 where there are keys to pad (its out uniform
    over the S keys on both sides)."""
    q, k, v, lengths, kw = _attn_fp32_inputs(dev, hd, B, T, H, case)
    before = flash_attention.launches
    out, lse = flash_attention.fused_attention(q, k, v, **kw, return_lse=True)
    assert flash_attention.launches == before + 1
    pout, plse = flash_attention.fused_attention_plain(q, k, v, **kw, return_lse=True)
    _close_f32(out, pout)
    valid = lengths > 0
    err = (lse[valid] - plse[valid]).abs() - 2 * 2.0 ** -23 * plse[valid].abs()
    assert err.max().item() <= 1e-4


@pytest.mark.parametrize("hd", FP32_ATTN_HDS)
@pytest.mark.parametrize("B,T,H", FP32_ATTN_SHAPES)
@pytest.mark.parametrize("case", FP32_ATTN_CASES)
def test_attention_backward_fp32_edges(dev, hd, B, T, H, case):
    """The fp32 dropout forward (rate 0.1) and the fp32 backward against
    their plain versions: out, dq, dk, dv as the fp32 products; dbias and
    dgate within 1e-5 of the sum of |terms|; lse within 1e-4 on rows with
    a key; two backward launches (the rows pre-pass and the kernel). Both
    backwards take the plain forward's out and lse; dO is 0 on the row of
    length 0, as in training (ROADMAP 3.5), and on the rows whose every key
    is padded or behind the -1e4 (T, S) mask: their logits sit near -1e4,
    where one fp32 ulp is 1e-3, so p carries that rounding on either side
    (the forward's lse check allows it too). With one key (T = 1) the softmax
    is constant: dS, and with it dq, dk, dbias and dgate, is 0 but for fp32
    rounding of dP - delta on either side, so those are held to 1e-5 of
    the scale of their terms instead."""
    _check_attention_backward_fp32(dev, hd, B, T, H, case, 0.1)


# the backward's head dims above 64: 72 and 80 (the width-80 form), 88 and 96
# (width 96), 120 and 128 (the width-128 form); T off the 32-query steps and
# the 64-key blocks, utterances off a tile (799 frames: 799 / 666 / 0), a
# row of length 0
FP32_BWD_WIDE_HDS = [72, 80, 88, 96, 120, 128]
FP32_BWD_WIDE_SHAPES = [(3, 799, 2), (2, 97, 3), (4, 161, 1)]


@pytest.mark.parametrize("hd", FP32_BWD_WIDE_HDS)
@pytest.mark.parametrize("B,T,H", FP32_BWD_WIDE_SHAPES)
@pytest.mark.parametrize("case", ["gate+kpm", "kpm"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_backward_fp32_wide_instances(dev, hd, B, T, H, case, rate):
    """The four instances of the fp32 backward (gated bias or none, dropout
    or none) at head dims above 64, held as test_attention_backward_fp32_edges
    holds them."""
    _check_attention_backward_fp32(dev, hd, B, T, H, case, rate)


def _check_attention_backward_fp32(dev, hd, B, T, H, case, rate):
    """The body of test_attention_backward_fp32_edges at dropout ``rate``
    (no seed at 0)."""
    q, k, v, lengths, kw = _attn_fp32_inputs(dev, hd, B, T, H, case)
    seed = torch.tensor([T * 977 + hd], dtype=torch.int64, device=dev) if rate > 0 else None
    before = flash_attention.launches
    out, lse = flash_attention.fused_attention(q, k, v, **kw, dropout_rate=rate,
                                               dropout_seed=seed, return_lse=True)
    assert flash_attention.launches == before + 1
    pout, plse = flash_attention.fused_attention_plain(q, k, v, **kw, dropout_rate=rate,
                                                       dropout_seed=seed, return_lse=True)
    _close_f32(out, pout)
    valid = lengths > 0
    err = (lse[valid] - plse[valid]).abs() - 2 * 2.0 ** -23 * plse[valid].abs()
    assert err.max().item() <= 1e-4
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(T + hd)).to(dev)
    rows = valid[:, None].expand(B, T)
    if "attn_mask" in kw:
        open_keys = (kw["attn_mask"] == 0)[None] & ~kw["key_padding_mask"][:, None, :]
        rows = rows & open_keys.any(-1)
    dout = dout * rows[:, :, None, None]
    args = (q, k, v, kw.get("bias"), kw.get("gate"), kw.get("key_padding_mask"),
            kw.get("attn_mask"), rate, seed, pout, plse, dout)
    before = flash_attention.backward_launches
    got = flash_attention.fused_attention_backward(*args)
    assert flash_attention.backward_launches == before + 2
    want = flash_attention.fused_attention_backward_plain(*args)
    assert all((a is None) == (b is None) for a, b in zip(got[3:], want[3:]))
    if T == 1:
        # |dS| <= rounding of dP and delta, each at most |dO| |v| hd
        ds = 1e-5 * dout.abs().max().item() * v.abs().max().item() * hd
        _close_f32(got[2], want[2])
        for a, scale in ((got[0], k.abs().max().item()), (got[1], q.abs().max().item()),
                         (got[3], B * 3.0), (got[4], kw.get("bias", q).abs().max().item())):
            if a is not None:
                assert a.abs().max().item() <= ds * scale
        return
    for a, b in zip(got[:3], want[:3]):
        _close_f32(a, b)
    if kw.get("bias") is not None:
        terms = attn_terms(*args)
        _sum_close(got[3], want[3], terms[0])
        if kw.get("gate") is not None:
            _sum_close(got[4], want[4], terms[1])


def test_attention_dropout_mask_is_bit_identical_fp32(dev):
    """The fp32 dropout forward's keep mask is the Philox mask of the plain
    version and of the bf16 kernel: q = k = 0, v the identity over keys."""
    from unispeech_tpu_torch.ops.kernels.philox import attention_keep

    B, T, H = 2, 64, 3
    q = torch.zeros(B, T, H, 64, device=dev)
    v = torch.eye(64, device=dev)[None, :, None, :].expand(B, T, H, 64).contiguous()
    seed = torch.tensor([987654321987], dtype=torch.int64, device=dev)
    out = flash_attention.fused_attention(q, q, v, dropout_rate=0.25, dropout_seed=seed)
    keep = attention_keep(seed, B, H, T, T, 0.25)
    assert torch.equal(out.permute(0, 2, 1, 3) != 0, keep)
    out16 = flash_attention.fused_attention(q.to(torch.bfloat16), q.to(torch.bfloat16),
                                            v.to(torch.bfloat16), dropout_rate=0.25,
                                            dropout_seed=seed)
    assert torch.equal(out16 != 0, out != 0)


@pytest.mark.parametrize("T", [1, 63, 65, 129, 799])
def test_attention_dropout_mask_is_bit_identical_fp32_tiles(dev, T):
    """The fp32 dropout forward's keep mask over T = S keys that cross its
    steps and blocks: q = k = 0 (p uniform), v the indicator of keys 64 j ..
    64 j + 63 in its 64 columns, one call per j; out != 0 exactly where
    attention_keep keeps (b, h, t, 64 j + c)."""
    from unispeech_tpu_torch.ops.kernels.philox import attention_keep

    B, H = 2, 3
    q = torch.zeros(B, T, H, 64, device=dev)
    seed = torch.tensor([123456789 + T], dtype=torch.int64, device=dev)
    keep = attention_keep(seed, B, H, T, T, 0.25)
    for j in range(-(-T // 64)):
        v = torch.zeros(T, 64, device=dev)
        n = min(64, T - 64 * j)
        v[64 * j:64 * j + n] = torch.eye(64, device=dev)[:n]
        v = v[None, :, None, :].expand(B, T, H, 64).contiguous()
        out = flash_attention.fused_attention(q, q, v, dropout_rate=0.25, dropout_seed=seed)
        assert torch.equal(out.permute(0, 2, 1, 3)[..., :n] != 0, keep[..., 64 * j:64 * j + n])
        assert (out[..., n:] == 0).all()


@pytest.mark.parametrize("hd", [64, 72, 80, 96, 128])
@pytest.mark.parametrize("case", ["gate+kpm", "none"])
def test_attention_backward_fp32_dk_dv_deterministic(dev, hd, case):
    """dK and dV of the fp32 backward are summed in a fixed order (in
    registers over the query steps), so two calls give them bit for bit; dq,
    dbias and dgate are sums over blocks in a run-dependent order."""
    B, T, H = 3, 129, 2
    q, k, v, lengths, kw = _attn_fp32_inputs(dev, hd, B, T, H, case)
    rate, seed = 0.1, torch.tensor([T + hd], dtype=torch.int64, device=dev)
    out, lse = flash_attention.fused_attention_plain(q, k, v, **kw, dropout_rate=rate,
                                                     dropout_seed=seed, return_lse=True)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(hd)).to(dev)
    dout = dout * (lengths > 0)[:, None, None, None]
    args = (q, k, v, kw.get("bias"), kw.get("gate"), kw.get("key_padding_mask"), None, rate,
            seed, out, lse, dout)
    first = flash_attention.fused_attention_backward(*args)
    second = flash_attention.fused_attention_backward(*args)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert torch.isfinite(first[1]).all() and torch.isfinite(first[2]).all()


# (B, t1, C) for the fp32 backward (l1_frontend.bwd_f32_plan: R = 16 rows
# per tile at C = 512, 128 at C = 64, 40 at C = 192, 8 at C = 1024): fewer
# tiles than blocks (1 x 79 rows: 5 tiles); more tiles than blocks, so the
# persistent blocks walk several utterances and refill the ring (2 x 9600 at
# C = 512: 1,200 tiles; 6 x 4097 at C = 1024; 3 x 9601 at C = 64); t1 one
# row before, on and after a tile's end (a tile cut by t1 copies its rows
# < t1 alone, and a thread whose rows all lie past t1 skips the tile)
L1_BWD_F32_SHAPES = [(1, 79, 512), (3, 999, 64), (2, 9600, 512), (2, 97, 512), (1, 1000, 1024),
                     (2, 333, 192), (6, 4097, 1024), (3, 9601, 64), (2, 15, 512), (2, 16, 512),
                     (2, 17, 512), (1, 127, 64), (1, 129, 64), (2, 7, 1024), (2, 9, 1024)]


@pytest.mark.parametrize("B,t1,C", L1_BWD_F32_SHAPES)
@pytest.mark.parametrize("k,stride", [(10, 5), (8, 4)])
@pytest.mark.parametrize("stats", [True, False])
def test_l1_backward_fp32_edges(dev, B, t1, C, k, stride, stats):
    """The fp32 L1 backward, with and without the sums' cotangents, against
    the plain version: one launch, dW within 1e-5 of the sum of |terms|."""
    _check_l1_backward_fp32(dev, B, t1, C, k, stride, stats, t1 % stride)


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("B,t1,C", [(3, 97, 512), (3, 1000, 64), (4, 333, 192)])
@pytest.mark.parametrize("k,stride", [(10, 5), (8, 4)])
@pytest.mark.parametrize("stats", [True, False])
def test_l1_backward_fp32_window_offsets(dev, B, t1, C, k, stride, stats, extra):
    """Utterances of (t1 - 1) stride + k + extra samples: with ns % 4 != 0
    the utterances after the first start off a 16-byte boundary, so the
    kernel takes each tile's samples from the boundary before its first."""
    _check_l1_backward_fp32(dev, B, t1, C, k, stride, stats, extra)


def test_l1_backward_fp32_unaligned_views(dev):
    """A waveform and a dy that start 4 bytes into their buffers, and sums
    8 bytes in: the fp32 kernel reads the waveform by TMA, dy by bulk
    copies and the sums as float4, all of which need 16-byte alignment."""
    g = torch.Generator().manual_seed(8)
    B, t1, C, k, s = 2, 97, 512, 10, 5
    ns = (t1 - 1) * s + k + 1
    wav = (torch.randn(B * ns + 1, generator=g) * 0.1).to(dev)[1:].view(B, ns)
    dy = torch.randn(B * t1 * C + 1, generator=g).to(dev)[1:].view(B, t1, C)
    w = (torch.randn(k, 1, C, generator=g) * 0.4).to(dev)
    ds1 = (torch.randn(B * C + 2, generator=g) * 1e-2).to(dev)[2:].view(B, C)
    ds2 = (torch.randn(B * C + 2, generator=g) * 1e-2).to(dev)[2:].view(B, C)
    assert wav.data_ptr() % 16 and dy.data_ptr() % 16 and ds1.data_ptr() % 16
    for sums in ((ds1, ds2), (None, None)):
        got = l1_frontend.l1_conv_backward(wav, w, s, dy, *sums, dtype=torch.float32)
        want = l1_frontend.l1_conv_backward_plain(wav, w, s, dy, *sums, torch.float32)
        _sum_close(got, want, l1_terms(wav, w, s, dy, *sums))


def _check_l1_backward_fp32(dev, B, t1, C, k, stride, stats, extra):
    g = torch.Generator().manual_seed(t1 + k + 5)
    ns = (t1 - 1) * stride + k + extra
    wav = (torch.randn(B, ns, generator=g) * 0.1).to(dev)
    w = (torch.randn(k, 1, C, generator=g) * 0.4).to(dev)
    dy = torch.randn(B, t1, C, generator=g).to(dev)
    ds1 = ds2 = None
    if stats:
        ds1 = (torch.randn(B, C, generator=g) * 1e-2).to(dev)
        ds2 = (torch.randn(B, C, generator=g) * 1e-2).to(dev)
    before = l1_frontend.backward_launches
    got = l1_frontend.l1_conv_backward(wav, w, stride, dy, ds1, ds2, dtype=torch.float32)
    assert l1_frontend.backward_launches == before + 1
    want = l1_frontend.l1_conv_backward_plain(wav, w, stride, dy, ds1, ds2, torch.float32)
    _sum_close(got, want, l1_terms(wav, w, stride, dy, ds1, ds2))


def test_fp32_route_rejects(dev):
    """fp32 runs the fp32 kernels in both directions: the dropout forward
    and the attention and L1 backwards launch and match their plain
    versions; fp16 and mixed dtypes (q/k/v, a bf16 dO under fp32 q, a bf16
    pre or dy under an fp32 block, a bf16 dy under the fp32 L1) raise;
    nothing is rounded to reach the bf16 kernels."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 40, 2, 64, generator=g).to(dev) for _ in range(3))
    seed = torch.tensor([5], dtype=torch.int64, device=dev)
    before = flash_attention.launches
    out = flash_attention.fused_attention(q, k, v, dropout_rate=0.1, dropout_seed=seed)
    assert flash_attention.launches == before + 1 and out.dtype == torch.float32
    _close_f32(out, flash_attention.fused_attention_plain(q, k, v, dropout_rate=0.1,
                                                          dropout_seed=seed))
    qg = q.clone().requires_grad_()
    out = flash_attention.fused_attention(qg, k, v)
    assert out.dtype == torch.float32
    before = flash_attention.backward_launches
    out.sum().backward()
    assert flash_attention.backward_launches == before + 2
    pout, plse = flash_attention.fused_attention_plain(q, k, v, return_lse=True)
    want = flash_attention.fused_attention_backward_plain(q, k, v, None, None, None, None, 0.0,
                                                          None, pout, plse, torch.ones_like(q))
    _close_f32(qg.grad, want[0])
    for qq, kk in ((q.half(), k.half()), (q, k.to(torch.bfloat16)),
                   (q.to(torch.bfloat16), k)):
        with pytest.raises(ValueError):
            flash_attention.fused_attention(qq, kk, v.to(qq.dtype))
    with pytest.raises(ValueError):  # a bf16 dO under fp32 q
        flash_attention.fused_attention_backward(q, k, v, None, None, None, None, 0.0, None,
                                                 pout, plse, torch.ones_like(q).bfloat16())
    with pytest.raises(ValueError):  # bf16 weights under an fp32 input
        conv_stack.conv_gelu_block(torch.zeros(1, 64, 128, device=dev),
                                   torch.zeros(3, 128, 128, device=dev, dtype=torch.bfloat16), 64)
    x, w = torch.zeros(1, 64, 128, device=dev), torch.zeros(3, 128, 128, device=dev)
    dy = torch.zeros(1, 31, 128, device=dev)
    for pre, d in ((dy.bfloat16(), dy), (dy, dy.bfloat16())):  # bf16 pre, bf16 dy
        with pytest.raises(ValueError):
            conv_stack.conv_gelu_block_backward(x, w, 64, False, True, None, d, pre)
    with pytest.raises(ValueError):  # the L1 kernels compute in bf16 or fp32
        l1_frontend.l1_conv_with_stats(torch.zeros(1, 400, device=dev),
                                       torch.zeros(10, 1, 64, device=dev), 5,
                                       dtype=torch.float16)
    wav = torch.randn(1, 4000, generator=g).to(dev)
    wk = torch.randn(10, 1, 64, generator=g).to(dev).requires_grad_()
    y, *_ = l1_frontend.l1_conv_with_stats(wav, wk, 5, dtype=torch.float32)
    before = l1_frontend.backward_launches
    y.sum().backward()
    assert l1_frontend.backward_launches == before + 1
    ones = torch.ones_like(y)
    _sum_close(wk.grad, l1_frontend.l1_conv_backward_plain(wav, wk.detach(), 5, ones, None,
                                                           None, torch.float32),
               l1_terms(wav, wk.detach(), 5, ones, None, None))
    with pytest.raises(ValueError):  # a bf16 dy under the fp32 L1
        l1_frontend.l1_conv_backward(wav, wk.detach(), 5, ones.bfloat16(), dtype=torch.float32)


@pytest.mark.parametrize("arch", ["base", "large"])
def test_small_model_fp32_kernel_path_matches_plain(dev, monkeypatch, arch):
    """A small WavLM built without a dtype (fp32, the default) on the card:
    launches per forward as in bf16, fp32 features within relative L2 1e-4
    of the plain path."""
    from unispeech_tpu_torch.configs import (
        WavLMModelConfig,
        base_encoder_config,
        large_encoder_config,
    )
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.wavlm import WavLM

    make = base_encoder_config if arch == "base" else large_encoder_config
    enc = make(encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
               encoder_attention_heads=2, conv_layers=((128, 10, 5),) + ((128, 3, 2),) * 2,
               conv_pos=16, conv_pos_groups=4, relative_position_embedding=True,
               gru_rel_pos=True, num_buckets=32, max_distance=64, dropout=0.0,
               attention_dropout=0.0)
    model = WavLM(WavLMModelConfig(encoder=enc),
                  generator=torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator().manual_seed(1)
    wav = (torch.randn(3, 6000, generator=g) * 0.1).to(dev)
    lengths = torch.tensor([6000, 4100, 2500], device=dev)
    mods = (l1_frontend, conv_stack, flash_attention)
    counts = [m.launches for m in mods]
    got = model.extract_features(wav, lengths=lengths).x
    # Base: two GEMMs and the first block's H pass; Large: H pass + GEMM per block
    assert [m.launches - c for m, c in zip(mods, counts)] == ([1, 3, 2] if arch == "base"
                                                              else [1, 4, 2])
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    want = model.extract_features(wav, lengths=lengths).x
    assert got.dtype == want.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 1e-4


@pytest.mark.parametrize("arch", ["base", "large"])
def test_small_model_fp32_train_step_kernel_path_matches_plain(dev, monkeypatch, arch):
    """A small HubertPretrainModel built without a dtype (fp32) on the card,
    in the default (Base) and the layer_norm (Large) structure: one masked
    step's gradients through the fp32 kernels against the plain path, per
    parameter |g - g_plain| <= 1e-3 |g_plain| + 1e-6 |global| (both paths
    in fp32: 3xTF32 rounding and summation order only); launches per step
    as in bf16 (conv backward: Base a g pass, dx and dW per block and the
    first block's H pass; Large an H pass, dx and dW per block)."""
    from unispeech_tpu_torch.configs import (
        HubertPretrainConfig,
        MaskConfig,
        base_encoder_config,
        large_encoder_config,
    )
    from unispeech_tpu_torch.models import encoder
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    make = base_encoder_config if arch == "base" else large_encoder_config
    enc = make(encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=256,
               encoder_attention_heads=2, conv_layers=((128, 10, 5),) + ((128, 3, 2),) * 2,
               conv_pos=16, conv_pos_groups=4, relative_position_embedding=True,
               gru_rel_pos=True, num_buckets=32, max_distance=64, dropout=0.0,
               attention_dropout=0.0, encoder_layerdrop=0.0, remat_layers=False)
    cfg = HubertPretrainConfig(encoder=enc, time_mask=MaskConfig(mask_prob=0.65, mask_length=4),
                               num_classes=(17,), final_dim=32)
    model = HubertPretrainModel(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    g = torch.Generator().manual_seed(1)
    T = enc.num_frames(6000)
    batch = {"source": (torch.randn(3, 6000, generator=g) * 0.1).to(dev),
             "targets": torch.randint(0, 17, (3, T, 1), generator=g).to(dev),
             "lengths": torch.tensor([6000, 4100, 2500], device=dev),
             "boundary_mask": (torch.rand(3, T, generator=g) < 0.5).to(dev)}
    loss_fn = make_hubert_loss_fn(model, HubertCriterionConfig())

    def grads():
        model.zero_grad(set_to_none=True)
        loss, ss, _ = loss_fn(batch, torch.Generator(), 0)
        (loss / ss).backward()
        return [p.grad.clone() for p in model.parameters()]

    mods = (l1_frontend, conv_stack, flash_attention)
    counts = [(m.launches, m.backward_launches) for m in mods]
    gk = grads()
    launched = [(m.launches - a, m.backward_launches - b) for m, (a, b) in zip(mods, counts)]
    assert launched == ([(1, 1), (3, 7), (2, 4)] if arch == "base"
                        else [(1, 1), (4, 6), (2, 4)])
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    gp = grads()
    total = torch.sqrt(sum((x * x).sum() for x in gp)).item()
    for (name, _), a, b in zip(model.named_parameters(), gk, gp):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        assert (a - b).norm().item() <= 1e-3 * b.norm().item() + 1e-6 * total, name
