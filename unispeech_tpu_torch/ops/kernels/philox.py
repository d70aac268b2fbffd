"""Philox-4x32-10 counter-based random numbers, plain PyTorch.

The attention kernel draws its dropout mask in-kernel from a seed
(``csrc/philox.cuh``); this module computes the same words with tensor ops,
bit for bit, so the kernel's plain version and the CPU tests regenerate the
identical mask. The TPU kernel used the chip's hardware PRNG, which has no
counterpart here.

Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011): a 4x32-bit counter and a 2x32-bit key, ten rounds. All
values are kept in int64 tensors holding unsigned 32-bit words; the 32x32 ->
64 products are taken in 16-bit limbs so no int64 product overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ROUNDS = 10

Words = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, x < 2**32."""
    m0, m1 = m & 0xFFFF, m >> 16
    x0, x1 = x & 0xFFFF, x >> 16
    p00, p01, p10, p11 = x0 * m0, x0 * m1, x1 * m0, x1 * m1  # each < 2**32
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi & MASK32, lo


def philox4x32(counter: Words, key: Tuple[torch.Tensor, torch.Tensor]) -> Words:
    """The four output words for each counter (broadcasting int64 tensors of
    unsigned 32-bit values); ``key`` is (k0, k1) in the same form."""
    c0, c1, c2, c3 = (c.to(torch.int64) & MASK32 for c in counter)
    k0, k1 = (k.to(torch.int64) & MASK32 for k in key)
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Philox key of a 1-element int64 seed: its low and high words."""
    s = seed.reshape(()).to(torch.int64)
    return s & MASK32, (s >> 32) & MASK32


def keep_threshold(rate: float) -> int:
    """A word ``w`` keeps its element iff w >= floor(rate * 2**32)."""
    return min(int(rate * 4294967296.0), MASK32)


def attention_keep(seed: torch.Tensor, B: int, H: int, T: int, S: int,
                   rate: float) -> torch.Tensor:
    """(B, H, T, S) bool keep mask of attention dropout.

    Element (b, h, t, s) reads word ``(s & 1) | (t & 1) << 1`` of the block
    with counter (s >> 1, t >> 1, h, b): a function of the absolute
    coordinates alone, so any tiling of the kernel draws the same mask."""
    dev = seed.device
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    c0 = ar((S + 1) // 2)[None, None, None, :]
    c1 = ar((T + 1) // 2)[None, None, :, None]
    c2 = ar(H)[None, :, None, None]
    c3 = ar(B)[:, None, None, None]
    w = philox4x32((c0, c1, c2, c3), seed_key(seed))  # (B, H, T/2, S/2) each
    thr = keep_threshold(rate)
    # interleave: rows t = 2i + (word >> 1), columns s = 2j + (word & 1)
    top = torch.stack([w[0], w[1]], dim=-1).flatten(-2)  # even t
    bot = torch.stack([w[2], w[3]], dim=-1).flatten(-2)  # odd t
    words = torch.stack([top, bot], dim=-2).flatten(-3, -2)
    return words[:, :, :T, :S] >= thr
