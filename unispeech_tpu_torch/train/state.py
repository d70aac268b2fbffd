"""Train state and the train step.

Counterpart of the JAX package's ``train/state.py``. Gradient semantics
match it: per-position losses are summed over all microbatches, the
gradients divided by the total sample size (at least 1), then clipped and
applied. A parameter that got no gradient (a layer layerdrop skipped, an
unused head) gets zeros, so AdamW decays its moments and applies weight
decay as optax does. Sharding (``shard_train_state``) waits for the port of
``parallel/``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from unispeech_tpu_torch.train.optim import OptimConfig, Optimizer, make_optimizer
from unispeech_tpu_torch.utils.device import device_or_raise

LossFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]]
# loss_fn(batch, generator, step) -> (loss_sum, sample_size, metrics) of the
# model it binds, the state's model


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: nn.Module, optimizer_cfg: OptimConfig,
                       device="cuda") -> TrainState:
    """Move the model to ``device`` and build its optimizer. The default is
    the card; tests pass "cpu"."""
    model = model.to(device_or_raise(device))
    return TrainState(model=model, optimizer=make_optimizer(optimizer_cfg, model.parameters()))


def _index(batch, i):
    return {k: v[i] for k, v in batch.items()}


def make_train_step(loss_fn: LossFn, accum_steps: int = 1, inner_steps: int = 1):
    """Build ``step(state, batch, generator) -> metrics``.

    ``accum_steps > 1``: the batch carries a leading (accum_steps, ...) axis;
    the raw gradients of the microbatches are summed and divided by the
    total sample size, exactly one step on the concatenated batch.
    ``inner_steps > 1``: the batch carries a leading (inner_steps, ...) axis
    (outside the accum axis) and K full optimizer steps run, one per
    microbatch; metrics come back stacked with a leading (K,) axis.

    Metrics are device tensors (plus ``layers_dropped``, a host int): the
    step issues no host sync; reading a metric is the caller's sync.
    """

    def one_step(state: TrainState, batch, generator) -> Dict[str, Any]:
        model, opt = state.model, state.optimizer
        model.train()
        for p in opt.params:
            p.grad = None
        micro = [batch] if accum_steps == 1 else [_index(batch, i) for i in range(accum_steps)]
        loss = sample_size = None
        metrics: Dict[str, Any] = {}
        for mb in micro:
            l, ss, met = loss_fn(mb, generator, state.step)
            l.backward()
            loss = l.detach() if loss is None else loss + l.detach()
            sample_size = ss.detach() if sample_size is None else sample_size + ss.detach()
            for k, v in met.items():
                v = v.detach() if torch.is_tensor(v) else v
                metrics[k] = v if k not in metrics else metrics[k] + v
        denom = torch.clamp(sample_size, min=1.0)
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in opt.params]
        torch._foreach_div_(grads, denom)
        grad_norm = torch.nn.utils.get_total_norm(grads)
        opt.step(grad_norm)
        state.step += 1
        metrics["grad_norm"] = grad_norm
        metrics["loss_per_sample"] = loss / denom
        return metrics

    if inner_steps == 1:
        return one_step

    def outer(state: TrainState, batch, generator) -> Dict[str, Any]:
        runs = [one_step(state, _index(batch, k), generator) for k in range(inner_steps)]
        return {k: torch.stack([r[k] for r in runs]) if torch.is_tensor(runs[0][k])
                else [r[k] for r in runs] for k in runs[0]}

    return outer


def shard_train_state(*args, **kwargs):
    """Placing the state on a device mesh waits for the port of ``parallel/``."""
    raise NotImplementedError("sharding (parallel/) is not ported to PyTorch yet")
