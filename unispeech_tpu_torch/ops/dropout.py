"""Seed-recompute dropout: the backward regenerates the keep mask from its
seed instead of storing it.

Counterpart of the JAX package's ``ops/dropout.py``. The mask is a pure
function of (seed, shape, device): a fresh ``torch.Generator`` on the
tensor's device seeded with ``seed`` draws it, in the forward and again in
the backward, so the only residual kept is an integer. The same holds when
``torch.utils.checkpoint`` re-runs the forward, so rematerialised layers
draw the mask they drew the first time, whatever explicit generator the
model was given (the caller draws the seed outside the checkpointed region).

Semantics of ``nn.Dropout``: keep with probability 1 - rate, kept values
scaled by 1 / (1 - rate).
"""

from __future__ import annotations

import torch

SEED_HIGH = 2**62  # seeds are drawn uniformly from [0, SEED_HIGH)


def draw_seeds(generator: torch.Generator, n: int) -> torch.Tensor:
    """``n`` int64 seeds from a host-side (CPU) generator."""
    if generator.device.type != "cpu":
        raise ValueError("the model draws its randomness on the host: pass a CPU "
                         "torch.Generator")
    return torch.randint(0, SEED_HIGH, (n,), generator=generator, dtype=torch.int64)


def device_generator(generator: torch.Generator, device=None) -> torch.Generator:
    """A generator on ``device`` seeded by one draw from ``generator`` (a
    host-side CPU generator): the samplers draw on the tensor's device, and
    the host generator's stream stays one seed per draw."""
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int(draw_seeds(generator, 1)))
    return gen


def keep_mask(seed: int, shape, rate: float, device) -> torch.Tensor:
    """The bool keep mask of ``seed``: a pure function of its arguments."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) >= rate


class _SeedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        keep = keep_mask(seed, x.shape, rate, x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))

    @staticmethod
    def backward(ctx, g):
        keep = keep_mask(ctx.seed, g.shape, ctx.rate, g.device)
        return torch.where(keep, g / (1.0 - ctx.rate), torch.zeros((), dtype=g.dtype,
                                                                    device=g.device)), None, None


def seed_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout whose mask is drawn from ``seed`` (an int) and regenerated in
    the backward; ``rate`` is the drop probability, 0 the identity."""
    if rate == 0.0:
        return x
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return _SeedDropout.apply(x, int(seed), float(rate))
