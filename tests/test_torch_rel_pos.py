"""The port's rel-pos buckets, bias and gate against the JAX ops (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.attention import rel_pos_gate as jax_gate
from unispeech_tpu.ops.rel_pos import compute_rel_pos_bias as jax_bias
from unispeech_tpu.ops.rel_pos import relative_position_bucket as jax_bucket
from unispeech_tpu_torch.ops.attention import rel_pos_gate
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias, relative_position_bucket


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 1280), (32, 64)])
def test_buckets_integer_exact(num_buckets, max_distance):
    rel = np.arange(-3000, 3001, dtype=np.int32)
    got = relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance)
    want = jax_bucket(jnp.asarray(rel), num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,S", [(1, 1), (37, 37), (50, 23), (799, 799)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_equal(T, S, dtype):
    """The bias only moves table values (and casts them once): exact."""
    table = np.random.RandomState(0).randn(320, 12).astype(np.float32)
    got = compute_rel_pos_bias(torch.from_numpy(table), T, S, 320, 1280,
                               dtype=getattr(torch, dtype))
    want = jax_bias(jnp.asarray(table), T, S, 320, 1280, dtype=getattr(jnp, dtype))
    assert got.shape == (12, T, S) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("T,S", [(1, 1), (37, 37), (50, 23), (799, 799), (64, 64)])
def test_bias_rows_padded_to_16_bytes(T, S):
    """The (H, T, S) bias is a view of rows padded to a multiple of 8 keys
    (whole 16-byte units of bf16, the CUDA attention kernels' TMA layout),
    heads T padded rows apart, with or without gradients."""
    table = torch.randn(32, 4)
    for grad in (False, True):
        got = compute_rel_pos_bias(table.clone().requires_grad_(grad), T, S, 32, 64,
                                   dtype=torch.bfloat16)
        rs = -(-S // 8) * 8
        assert got.shape == (4, T, S) and got.stride() == (T * rs, rs, 1)
        assert got.untyped_storage().nbytes() == 4 * T * rs * 2


def test_gate_equal():
    """fp32 island of a (hd, 8) projection: fp32 rounding only."""
    rng = np.random.RandomState(0)
    B, T, H, hd = 2, 33, 4, 16
    x = rng.randn(B, T, H * hd).astype(np.float32)
    w = (rng.randn(hd, 8) * 0.2).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    a = rng.rand(1, H, 1, 1).astype(np.float32)
    got = rel_pos_gate(*map(torch.from_numpy, (x, w, b, a)), H)
    want = jax_gate(*map(jnp.asarray, (x, w, b, a)), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
