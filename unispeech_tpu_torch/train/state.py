"""Train state and the train step.

Counterpart of the JAX package's ``train/state.py``. Gradient semantics
match it: per-position losses are summed over all microbatches, the
gradients divided by the total sample size (at least 1), then clipped and
applied. A parameter that got no gradient (a layer layerdrop skipped, an
unused head) gets zeros, so AdamW decays its moments and applies weight
decay as optax does.

Across processes (``shard_train_state`` over a ``parallel.sharding`` mesh)
the semantics stay the JAX package's: the gradients are summed over all
data ranks and microbatches, then divided by the global sample size; the
loss, the sample size and every metric sum are all-reduced over the data
ranks, so each rank logs the global values (the few batch-level ratios,
perplexities and the SAT mean, are averaged over the data ranks instead);
``grad_norm`` is the global norm, each shard counted once. Data
parallelism all-reduces the gradients once per update; FSDP reduce-scatters
them in each backward, with its divide factor set to 1. A batch-level term
(the feature penalty, the codebook diversity) is computed on each rank's
rows, as fairseq's data-parallel workers compute it: it equals the
one-process value when the data ranks' sample sizes are equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from unispeech_tpu_torch.parallel.sharding import is_dtensor, local_tensor
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
    mesh: Any = None  # the parallel.sharding mesh once shard_train_state placed it
    fsdp: bool = False
    # per optimizer parameter, 1 / the number of ranks holding its local piece
    norm_weights: Optional[torch.Tensor] = None


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
        model, opt, mesh = state.model, state.optimizer, state.mesh
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
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None and mesh["data"].size() > 1:
            # FSDP reduced its own parameters' gradients in the backward;
            # the rest are summed here, once per update
            group = mesh["data"].get_group()
            all_reduce_sum([p.grad for p in opt.params if not is_dtensor(p)], group)
            loss, sample_size, metrics = _reduce_metrics(loss, sample_size, metrics, group,
                                                         mesh["data"].size())
        denom = torch.clamp(sample_size, min=1.0)
        grads = [local_tensor(p.grad) for p in opt.params]
        torch._foreach_div_(grads, denom)
        grad_norm = (torch.nn.utils.get_total_norm(grads) if mesh is None
                     else global_grad_norm(grads, state.norm_weights))
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


# metrics that are ratios or means of the rank's batch, not sums
MEAN_METRICS = frozenset({"code_perplexity", "prob_perplexity", "loss_prob_perplexity",
                          "loss_spk_m", "contrastive_acc"})

_BUCKET = 1 << 25  # elements per all-reduce of the flat gradients


def all_reduce_sum(tensors, group) -> None:
    """Sum each tensor over ``group`` in place, a few flat buffers at a time."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel() <= _BUCKET):
            n += tensors[j].numel()
            j += 1
        chunk = tensors[i:j]
        flat = _flatten_dense_tensors(chunk)
        dist.all_reduce(flat, group=group)
        for t, r in zip(chunk, _unflatten_dense_tensors(flat, chunk)):
            t.copy_(r)
        i = j


def _reduce_metrics(loss, sample_size, metrics, group, n_data):
    """Loss, sample size and the tensor metrics summed over the data ranks
    in one all-reduce (``MEAN_METRICS`` averaged); host numbers, the same on
    every rank, stay."""
    import torch.distributed as dist

    names = [k for k, v in metrics.items() if torch.is_tensor(v)]
    vals = [loss, sample_size] + [metrics[k] for k in names]
    flat = torch.stack([v.to(device=loss.device, dtype=torch.float64).reshape(())
                        for v in vals])
    dist.all_reduce(flat, group=group)
    out = [r.to(v.dtype) for v, r in zip(vals, flat.unbind())]
    for k, v in zip(names, out[2:]):
        metrics[k] = v / n_data if k in MEAN_METRICS else v
    return out[0], out[1], metrics


def global_grad_norm(grads, weights) -> torch.Tensor:
    """The norm of the whole model's gradient from this rank's local pieces:
    each piece's squared norm times its weight (1 / the number of ranks
    holding the same piece), summed over all ranks."""
    import torch.distributed as dist

    norms = torch.stack(torch._foreach_norm(grads)).float()
    total = (norms * norms * weights.to(norms.device)).sum()
    dist.all_reduce(total)
    return total.sqrt()


def shard_train_state(state: TrainState, mesh, tensor_parallel: bool = False,
                      fsdp: bool = False) -> TrainState:
    """Place ``state`` (an unsharded model and its optimizer, no update made
    yet) on ``mesh``: with ``tensor_parallel`` the encoder layers split over
    the "model" ranks; with ``fsdp`` each encoder layer and then the rest of
    the model are ``fully_shard``-ed over the "data" ranks, gradients summed
    (divide factor 1), every parameter a DTensor (the foreach AdamW takes
    no mix of DTensors and tensors). The optimizer is rebuilt over the
    placed parameters. Returns the state, which the train step then drives
    across the ranks."""
    from unispeech_tpu_torch.models.encoder import TransformerEncoderLayer
    from unispeech_tpu_torch.parallel.tensor_parallel import ModelGroup, apply_tensor_parallel

    model = state.model
    if tensor_parallel and mesh["model"].size() > 1:
        apply_tensor_parallel(model, ModelGroup(mesh["model"].get_group(),
                                                mesh.get_local_rank("model"),
                                                mesh["model"].size()))
    if fsdp:
        from torch.distributed.fsdp import FSDPModule, fully_shard

        data = mesh["data"]
        for m in model.modules():
            # the layer holding the rel-pos table (layer 0), which the
            # encoder reads outside the layer, goes with the root's group
            if isinstance(m, TransformerEncoderLayer) and not hasattr(
                    m.self_attn, "relative_attention_bias"):
                fully_shard(m, mesh=data)
        fully_shard(model, mesh=data)
        for m in model.modules():
            if isinstance(m, FSDPModule):
                m.set_gradient_divide_factor(1.0)
                m.set_force_sum_reduction_for_comms(True)  # gloo has no PREMUL_SUM
    opt = make_optimizer(state.optimizer.cfg, model.parameters())
    opt.count = state.optimizer.count
    splits = getattr(model, "tp_splits", {})
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    n_data, n_model = mesh["data"].size(), mesh["model"].size()
    weights = torch.tensor([(1.0 if is_dtensor(p) else 1.0 / n_data)
                            * (1.0 if n in splits else 1.0 / n_model)
                            for n, p in zip(trainable, opt.params)], dtype=torch.float32)
    return TrainState(model=model, optimizer=opt, step=state.step, mesh=mesh, fsdp=fsdp,
                      norm_weights=weights)
