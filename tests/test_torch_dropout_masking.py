"""The port's random pieces: Philox, seed-recompute dropout and the masking
helpers, against the algorithm's published vectors and the JAX package.

The two frameworks draw different numbers from a seed, so the samplers are
held to JAX's in distribution (statistics over many rows) and to its exact
output where a function is deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from unispeech_tpu.configs import MaskConfig as JMaskConfig
from unispeech_tpu.ops import masking as jm
from unispeech_tpu_torch.configs import MaskConfig
from unispeech_tpu_torch.ops import masking
from unispeech_tpu_torch.ops.dropout import draw_seeds, keep_mask, seed_dropout
from unispeech_tpu_torch.ops.kernels.philox import (
    attention_keep,
    keep_threshold,
    philox4x32,
    seed_key,
)

# Random123's known-answer vectors for philox4x32 with 10 rounds:
# (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = philox4x32(tuple(map(t, ctr)), tuple(map(t, key)))
    assert tuple(int(x) for x in got) == want


def test_attention_keep_reads_the_documented_word():
    """Element (b, h, t, s) is word (s & 1) | (t & 1) << 1 of the block with
    counter (s >> 1, t >> 1, h, b), for a 64-bit seed's two words."""
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64)
    B, H, T, S, rate = 2, 3, 9, 11, 0.4
    keep = attention_keep(seed, B, H, T, S, rate)
    k0, k1 = seed_key(seed)
    rng = np.random.RandomState(0)
    for _ in range(40):
        b, h, t, s = (int(rng.randint(n)) for n in (B, H, T, S))
        w = philox4x32(tuple(torch.tensor(c) for c in (s >> 1, t >> 1, h, b)), (k0, k1))
        word = int(w[(s & 1) | ((t & 1) << 1)])
        assert bool(keep[b, h, t, s]) == (word >= keep_threshold(rate))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_keep_rate_within_binomial_bounds(rate):
    keep = attention_keep(torch.tensor([99], dtype=torch.int64), 4, 4, 64, 64, rate)
    n = keep.numel()
    frac = keep.float().mean().item()
    assert abs(frac - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_seed_dropout_keep_rate_and_recomputed_mask(rate):
    """Keep rate within 5 binomial sigmas; kept values scaled by 1/(1-rate);
    the backward (and a checkpoint recompute) regenerates the same mask."""
    x = torch.randn(64, 1000).requires_grad_()
    y = seed_dropout(x, 12345, rate)
    keep = y.detach() != 0
    frac = keep.float().mean().item()
    assert abs(frac - (1 - rate)) <= 5 * (rate * (1 - rate) / keep.numel()) ** 0.5
    np.testing.assert_allclose(y.detach()[keep].numpy(), (x.detach()[keep] / (1 - rate)).numpy(),
                               rtol=1e-6)
    assert torch.equal(keep, keep_mask(12345, x.shape, rate, x.device))
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), (keep.float() / (1 - rate)).numpy(), rtol=1e-6)
    x2 = x.detach().clone().requires_grad_()
    checkpoint(lambda v: seed_dropout(v, 12345, rate) * 2.0, x2, use_reentrant=False).sum().backward()
    np.testing.assert_allclose(x2.grad.numpy(), 2 * x.grad.numpy(), rtol=1e-6)
    assert not torch.equal(keep, seed_dropout(x.detach(), 54321, rate) != 0)
    assert seed_dropout(x, 1, 0.0) is x


def test_draw_seeds_reproducible():
    s = draw_seeds(torch.Generator().manual_seed(0), 5)
    assert s.dtype == torch.int64 and s.shape == (5,) and (s >= 0).all()
    assert torch.equal(s, draw_seeds(torch.Generator().manual_seed(0), 5))


@pytest.mark.parametrize("selection,other", [("static", 0.0), ("uniform", 2.0),
                                             ("normal", 2.0), ("poisson", 0.0)])
def test_span_mask_statistics_match_jax(selection, other):
    """Masked fraction within 0.03 of JAX's over 64 x 500 frames, padding
    never masked, min_masks honoured."""
    kw = dict(mask_prob=0.65, mask_length=10, mask_selection=selection, mask_other=other,
              min_masks=2)
    B, T = 64, 500
    lengths = np.concatenate([np.full(32, T), np.full(32, 250)]).astype(np.int32)
    jmask = np.asarray(jm.sample_span_mask(jax.random.PRNGKey(0), B, T, JMaskConfig(**kw),
                                           jnp.asarray(lengths)))
    mask = masking.sample_span_mask(torch.Generator().manual_seed(0), B, T, MaskConfig(**kw),
                                    torch.from_numpy(lengths)).numpy()
    assert mask.shape == (B, T) and mask.dtype == np.bool_
    assert not mask[32:, 250:].any()
    for rows in (slice(0, 32), slice(32, 64)):
        n = lengths[rows][0]
        assert abs(mask[rows, :n].mean() - jmask[rows, :n].mean()) < 0.03
    tiny = MaskConfig(mask_prob=0.01, mask_length=3, min_masks=2)
    m = masking.sample_span_mask(torch.Generator().manual_seed(1), B, T, tiny)
    assert int(m.sum(1).min()) >= 2
    assert not masking.sample_span_mask(torch.Generator(), B, T,
                                        MaskConfig(mask_prob=0.0)).any()


def test_deterministic_helpers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 5).astype(np.float32)
    tmask = rng.rand(2, 7) < 0.4
    cmask = rng.rand(2, 5) < 0.4
    emb = rng.randn(5).astype(np.float32)
    np.testing.assert_array_equal(
        masking.apply_time_mask(torch.from_numpy(x), torch.from_numpy(tmask),
                                torch.from_numpy(emb)).numpy(),
        np.asarray(jm.apply_time_mask(jnp.asarray(x), jnp.asarray(tmask), jnp.asarray(emb))))
    np.testing.assert_array_equal(
        masking.apply_channel_mask(torch.from_numpy(x), torch.from_numpy(cmask)).numpy(),
        np.asarray(jm.apply_channel_mask(jnp.asarray(x), jnp.asarray(cmask))))
    for T, chunk, left in ((10, 3, -1), (10, 3, 1), (7, 7, 0)):
        np.testing.assert_array_equal(masking.make_streaming_mask(T, chunk, left).numpy(),
                                      np.asarray(jm.make_streaming_mask(T, chunk, left)))
    bounds = [0.0, 0.11, 0.5, 0.93]
    np.testing.assert_array_equal(masking.frames_to_segments(bounds, 60, 50.0),
                                  jm.frames_to_segments(bounds, 60, 50.0))
    lengths = torch.tensor([16000, 9000])
    np.testing.assert_array_equal(masking.frame_padding_mask(lengths, 16000, 49).numpy(),
                                  np.asarray(jm.frame_padding_mask(jnp.asarray(lengths.numpy()),
                                                                   16000, 49)))


def test_boundary_mask_flips_whole_segments():
    seg = torch.tensor([[0, 0, 1, 1, 1, 2, -1, -1], [3, 3, 3, 0, 0, 1, 1, -1]])
    m = masking.sample_boundary_mask(torch.Generator().manual_seed(0), seg, p=0.5,
                                     max_segments=8)
    assert not m[seg < 0].any()
    for b in range(2):
        for sid in seg[b].unique().tolist():
            if sid >= 0:
                vals = m[b][seg[b] == sid]
                assert bool(vals.all()) or not bool(vals.any())
    frac = masking.sample_boundary_mask(torch.Generator().manual_seed(1),
                                        torch.arange(512).repeat(64, 1), p=0.3).float().mean()
    assert abs(frac.item() - 0.3) < 0.02
