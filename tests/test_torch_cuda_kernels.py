"""The port's CUDA kernels against their plain versions at edge shapes, on the
card (skipped without one). Run there with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``: the
repo's conftest imports JAX, which the port's machines need not have.

chip_smoke.py checks the kernels at the main path's shapes; these cases
cover what it does not reach: ragged and very short sequences, tiles cut by
t_out or T, strided q/k/v views, a bias without a gate, and the inputs each
wrapper must reject. Tolerance: one bf16 ulp at the tensor's scale (two fp32
accumulation orders may round to neighbouring bf16 values); attention 2 ulps
(its online softmax rounds P against a running max).
"""

import pytest
import torch

from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

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


@pytest.mark.parametrize("B,ns,C", [(1, 400, 512), (3, 5003, 64), (2, 16000 * 3 + 7, 512)])
def test_l1_edges(dev, B, ns, C):
    g = torch.Generator().manual_seed(ns)
    wav = (torch.randn(B, ns, generator=g) * 0.1).to(dev)
    w = (torch.randn(10, 1, C, generator=g) * 0.4).to(dev)
    y, s1, s2, t1 = l1_frontend.l1_conv_with_stats(wav, w, 5)
    py, ps1, ps2, pt1 = l1_frontend.l1_conv_with_stats_plain(wav, w, 5)
    assert t1 == pt1 == (ns - 10) // 5 + 1
    _close(y, py)
    mag = py.float().abs().sum(1)
    assert ((s1 - ps1).abs() / mag).max() <= 1e-4
    assert ((s2 - ps2).abs() / py.float().square().sum(1)).max() <= 1e-4


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


def _attn_inputs(dev, B, T, H, seed, fused_qkv=False):
    g = torch.Generator().manual_seed(seed)
    if fused_qkv:  # q/k/v as strided views of one (B, T, 3, H, 64) projection
        qkv = torch.randn(B, T, 3, H, 64, generator=g).to(dev, torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, T, H, 64, generator=g).to(dev, torch.bfloat16)
                   for _ in range(3))
    bias = torch.randn(H, T, T, generator=g).to(dev, torch.bfloat16)
    gate = (torch.rand(B, H, T, generator=g) * 2 + 1).to(dev)
    lengths = torch.tensor([T - (i * T) // (2 * B) for i in range(B)], device=dev)
    kpm = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
    return q, k, v, bias, gate, kpm


@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (2, 63, 2), (3, 65, 4), (2, 200, 12)])
@pytest.mark.parametrize("case", ["full", "bias_no_gate", "no_bias", "attn_mask", "strided"])
def test_attention_edges(dev, B, T, H, case):
    q, k, v, bias, gate, kpm = _attn_inputs(dev, B, T, H, seed=T * 7 + H,
                                            fused_qkv=case == "strided")
    kw = dict(bias=bias, gate=gate, key_padding_mask=kpm)
    if case == "bias_no_gate":
        kw["gate"] = None
    elif case == "no_bias":
        kw = dict(key_padding_mask=kpm)
    elif case == "attn_mask":
        idx = torch.arange(T, device=dev)
        kw["attn_mask"] = torch.where((idx[:, None] - idx[None, :]).abs() > 20, -1e4, 0.0)
    out, lse = flash_attention.fused_attention(q, k, v, **kw, return_lse=True)
    pout, plse = flash_attention.fused_attention_plain(q, k, v, **kw, return_lse=True)
    _close(out, pout, ulps=2.0)
    assert (lse - plse).abs().max().item() <= 1e-3


def test_wrappers_reject(dev):
    x = torch.zeros(1, 64, 128, device=dev)
    w = torch.zeros(3, 128, 128, device=dev)
    with pytest.raises(ValueError):  # fp32 input: the kernel computes in bf16
        conv_stack.conv_gelu_block(x, w, 64)
    with pytest.raises(ValueError):  # 96 channels: not a multiple of 128
        conv_stack.conv_gelu_block(torch.zeros(1, 64, 96, device=dev, dtype=torch.bfloat16),
                                   torch.zeros(3, 96, 96, device=dev), 64)
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim 32
        flash_attention.fused_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        flash_attention.fused_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError):  # the L1 kernel takes an fp32 waveform
        l1_frontend.l1_conv_with_stats(torch.zeros(1, 400, device=dev, dtype=torch.bfloat16),
                                       torch.zeros(10, 1, 64, device=dev), 5)


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
    assert launched == [0 if over else 1, 2, 2]
    monkeypatch.setattr(encoder, "l1_conv_with_stats", l1_frontend.l1_conv_with_stats_plain)
    monkeypatch.setattr(encoder, "conv_gelu_block", conv_stack.conv_gelu_block_plain)
    monkeypatch.setattr(encoder, "fused_attention", flash_attention.fused_attention_plain)
    want = model.extract_features(wav, lengths=lengths).x
    assert torch.isfinite(got).all()
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 2e-2
