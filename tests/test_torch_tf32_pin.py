"""The port's fp32 convolutions run without TF32 whatever the process's
``torch.backends.cudnn.allow_tf32`` (PyTorch's default is True, which on the
card computes an fp32 cuDNN convolution in TF32, about three decimal digits;
the JAX package computes it in fp32).

On the CPU the flag changes no result, so these tests record the flag that
each convolution sees: ``F.conv1d`` in the forward, and
``torch.nn.grad.conv1d_input`` / ``conv1d_weight`` in the backward, which
autograd runs after the forward's context has closed. The global flag is set
True around every test and must read True again after each call.
"""

import pytest
import torch
import torch.nn.functional as F

from unispeech_tpu_torch.ops import fp32_conv


@pytest.fixture
def tf32_on():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = prev


@pytest.fixture
def record(monkeypatch, tf32_on):
    """(kind, dtype, flag) of every conv1d forward and backward call."""
    calls = []
    fwd, gin, gw = F.conv1d, torch.nn.grad.conv1d_input, torch.nn.grad.conv1d_weight

    def conv(x, *args, **kw):
        calls.append(("forward", x.dtype, torch.backends.cudnn.allow_tf32))
        return fwd(x, *args, **kw)

    def conv_input(size, w, gy, *args, **kw):
        calls.append(("input", gy.dtype, torch.backends.cudnn.allow_tf32))
        return gin(size, w, gy, *args, **kw)

    def conv_weight(x, size, gy, *args, **kw):
        calls.append(("weight", gy.dtype, torch.backends.cudnn.allow_tf32))
        return gw(x, size, gy, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv1d", conv)
    monkeypatch.setattr(torch.nn.grad, "conv1d_input", conv_input)
    monkeypatch.setattr(torch.nn.grad, "conv1d_weight", conv_weight)
    return calls


def _check(calls, kinds):
    """Every recorded fp32 call saw the flag off; each kind was seen; the
    global flag is back on."""
    assert torch.backends.cudnn.allow_tf32
    f32 = [c for c in calls if c[1] == torch.float32]
    assert f32 and all(not flag for _, _, flag in f32), calls
    assert {k for k, _, _ in f32} >= set(kinds), calls
    return f32


@pytest.mark.parametrize("arch", ["base", "large"])
def test_fp32_model_convs_run_without_tf32(record, arch):
    """A tiny WavLM built without a dtype (fp32): the L1 and conv blocks'
    convolutions, the positional conv, in the forward and the backward."""
    from unispeech_tpu_torch.configs import (
        WavLMModelConfig,
        base_encoder_config,
        large_encoder_config,
    )
    from unispeech_tpu_torch.models.wavlm import WavLM

    make = base_encoder_config if arch == "base" else large_encoder_config
    enc = make(encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
               encoder_attention_heads=2, conv_layers=((32, 10, 5),) + ((32, 3, 2),) * 2,
               conv_pos=8, conv_pos_groups=4, relative_position_embedding=True,
               gru_rel_pos=True, num_buckets=16, max_distance=32, dropout=0.0,
               attention_dropout=0.0)
    model = WavLM(WavLMModelConfig(encoder=enc), generator=torch.Generator().manual_seed(0))
    wav = torch.randn(2, 2000, generator=torch.Generator().manual_seed(1)) * 0.1
    out = model(wav, lengths=torch.tensor([2000, 1500])).x
    assert out.dtype == torch.float32
    n_fwd = len(_check(record, ["forward"]))
    assert n_fwd >= len(enc.conv_layers) + 1  # the frontend's convs and the positional conv
    out.square().mean().backward()
    _check(record, ["forward", "input", "weight"])
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


def test_ecapa_head_convs_run_without_tf32(record):
    """The ECAPA-TDNN head (fp32): every Conv1d, forward and backward."""
    from unispeech_tpu_torch.downstream import ecapa_tdnn as ecapa

    model = ecapa.EcapaTdnn(ecapa.EcapaConfig(channels=64, emb_dim=32, scale=4,
                                              num_layer_feats=3), 16,
                            generator=torch.Generator().manual_seed(0))
    n_convs = sum(isinstance(m, torch.nn.Conv1d) for m in model.modules())
    assert n_convs and all(isinstance(m, fp32_conv.Conv1d) for m in model.modules()
                           if isinstance(m, torch.nn.Conv1d))
    feats = torch.randn(3, 2, 50, 16, generator=torch.Generator().manual_seed(1))
    emb = model(feats, torch.zeros(2, 50, dtype=torch.bool))
    assert len(_check(record, ["forward"])) >= n_convs
    emb.square().sum().backward()
    f32 = _check(record, ["forward", "input", "weight"])
    assert sum(k == "weight" for k, _, _ in f32) >= n_convs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding,dilation,groups,bias", [
    (5, 1, 2, 1, 1, True),
    (3, 2, 0, 1, 1, False),
    (4, 1, "same", 1, 1, True),  # odd total padding: the extra column on the right
    (3, 1, "same", 3, 1, True),
    (8, 1, 4, 1, 4, True),  # the grouped positional conv's form
])
def test_conv1d_matches_functional(tf32_on, dtype, k, stride, padding, dilation, groups, bias):
    """``fp32_conv.conv1d`` is ``F.conv1d``: the output and the gradients of
    x, w and b (bf16 goes to ``F.conv1d`` as it is)."""
    g = torch.Generator().manual_seed(k * 10 + stride + dilation)
    x = torch.randn(2, 8, 23, generator=g).to(dtype)
    w = (torch.randn(12, 8 // groups, k, generator=g) * 0.3).to(dtype)
    b = torch.randn(12, generator=g).to(dtype) if bias else None
    dy = None
    grads = []
    for fn in (fp32_conv.conv1d, F.conv1d):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        bs = None if b is None else b.clone().requires_grad_()
        y = fn(xs, ws, bs, stride, padding, dilation, groups)
        if dy is None:
            dy = torch.randn(y.shape, generator=g).to(dtype)
        y.backward(dy)
        grads.append((y.detach(), xs.grad, ws.grad, None if bs is None else bs.grad))
        assert torch.backends.cudnn.allow_tf32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            assert got.shape == want.shape and got.dtype == want.dtype
            torch.testing.assert_close(got.float(), want.float(), **tol)
