"""Optimizer and learning-rate schedules.

Counterpart of the JAX package's ``train/optim.py`` (optax there):
``torch.optim.AdamW`` on the fp32 parameters, the learning rate set from the
schedule at the 0-based update count before each update (as optax's
``scale_by_learning_rate`` reads its count), and an optional global-norm
clip applied to the gradients first, as ``optax.clip_by_global_norm``
does. AdamW's decoupled decay p *= 1 - lr * wd followed by the Adam step is
optax's adamw update -lr * (m^ / (sqrt(v^) + eps) + wd * p) of the same p.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Tuple

import torch

from unispeech_tpu_torch.parallel.sharding import local_tensor


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 5e-4
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-6
    weight_decay: float = 0.01
    clip_norm: float = 0.0  # 0 disables (fairseq default)
    schedule: str = "polynomial_decay"  # polynomial_decay | tri_stage | inverse_sqrt | fixed
    total_steps: int = 400_000
    warmup_steps: int = 32_000
    # polynomial_decay
    end_learning_rate: float = 0.0
    power: float = 1.0
    # tri_stage
    hold_steps: int = 0
    decay_steps: int = 0
    init_lr_scale: float = 0.01
    final_lr_scale: float = 0.05
    # inverse_sqrt
    warmup_init_lr: float = 0.0
    # The JAX package's stacked update groups same-shape leaves for one big
    # fused update; it is exact by construction (elementwise AdamW with
    # uniform hyper-parameters and a global norm are unchanged by grouping),
    # so it changes nothing here and is accepted for config parity only.
    stacked_update: bool = False


Schedule = Callable[[int], float]


def polynomial_decay_schedule(cfg: OptimConfig) -> Schedule:
    """Linear warmup from 0, then (lr - end) * (1 - progress)^power + end."""

    def fn(step: int) -> float:
        if step < cfg.warmup_steps:
            return cfg.lr * step / max(cfg.warmup_steps, 1)
        total = max(cfg.total_steps - cfg.warmup_steps, 1)
        pct = min(max((step - cfg.warmup_steps) / total, 0.0), 1.0)
        return (cfg.lr - cfg.end_learning_rate) * (1.0 - pct) ** cfg.power + cfg.end_learning_rate

    return fn


def tri_stage_schedule(cfg: OptimConfig) -> Schedule:
    """Warmup (init_lr_scale * lr -> lr), hold, exponential decay to
    final_lr_scale * lr."""
    init_lr = cfg.init_lr_scale * cfg.lr
    final_lr = cfg.final_lr_scale * cfg.lr
    decay_steps = cfg.decay_steps or max(cfg.total_steps - cfg.warmup_steps - cfg.hold_steps, 1)
    decay_factor = -math.log(cfg.final_lr_scale) / decay_steps

    def fn(step: int) -> float:
        in_decay = step - cfg.warmup_steps - cfg.hold_steps
        if step < cfg.warmup_steps:
            lr = init_lr + (cfg.lr - init_lr) * min(max(step / max(cfg.warmup_steps, 1), 0.0), 1.0)
        elif step < cfg.warmup_steps + cfg.hold_steps:
            lr = cfg.lr
        else:
            lr = cfg.lr * math.exp(-decay_factor * min(max(in_decay, 0.0), decay_steps))
        return max(lr, final_lr if in_decay >= decay_steps else 0.0)

    return fn


def inverse_sqrt_schedule(cfg: OptimConfig) -> Schedule:
    """Linear warmup from warmup_init_lr to lr, then lr * sqrt(warmup / step)."""
    warmup = max(cfg.warmup_steps, 1)
    lr_step = (cfg.lr - cfg.warmup_init_lr) / warmup
    decay_factor = cfg.lr * math.sqrt(warmup)

    def fn(step: int) -> float:
        if step < warmup:
            return cfg.warmup_init_lr + step * lr_step
        return decay_factor / math.sqrt(max(step, 1))

    return fn


def make_schedule(cfg: OptimConfig) -> Schedule:
    if cfg.schedule == "polynomial_decay":
        return polynomial_decay_schedule(cfg)
    if cfg.schedule == "tri_stage":
        return tri_stage_schedule(cfg)
    if cfg.schedule == "inverse_sqrt":
        return inverse_sqrt_schedule(cfg)
    if cfg.schedule == "fixed":
        return lambda step: cfg.lr
    raise ValueError(cfg.schedule)


class Optimizer:
    """AdamW with the schedule and the optional clip; ``count`` is the
    number of updates made."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig):
        self.cfg = cfg
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg)
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=cfg.adam_betas,
                                       eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
        self.count = 0

    def step(self, grad_norm: torch.Tensor) -> None:
        """One update from the parameters' ``.grad`` (all set), whose global
        norm is ``grad_norm`` (a device scalar: no host sync)."""
        if self.cfg.clip_norm and self.cfg.clip_norm > 0:
            clip = grad_norm >= self.cfg.clip_norm
            for p in self.params:
                g = local_tensor(p.grad)  # an FSDP gradient's own shard
                g.copy_(torch.where(clip, g / grad_norm * self.cfg.clip_norm, g))
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(params, cfg)
