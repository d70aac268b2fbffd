"""Megatron-style tensor parallelism of the encoder layers.

Each model rank holds its slice of q/k/v_proj and fc1 (output rows: its
heads, its FFN units) and of out_proj and fc2 (input columns) as ordinary
``nn.Parameter``s; every other parameter stays whole on every rank. Two
autograd pieces carry the layer: ``copy_to_model`` (identity forward,
all-reduce of the gradient backward) on the layer input before the
column-split products, and ``reduce_from_model`` (all-reduce forward,
identity backward) after the row-split products, whose bias is added once,
after the reduce (``models.encoder.linear`` does it for a linear marked
with ``tp_split``). The encoder's own code reads the split (local heads,
the bias rows and gate scales of those heads, the layer input's chunks of
those heads for the rel-pos gate); hooks of ``parallelize_module`` would
never fire, as the port calls no ``nn.Linear.forward``.

A GLU ``fc1`` (one Linear(d, 2F) whose halves a, b gate as a * silu(b))
gives each rank its slice of both halves, so the local a and b still pair.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """The model dimension as one rank sees it."""

    group: Any  # the ProcessGroup of this rank's model ranks
    rank: int
    size: int


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over the model ranks
    (the input of a column-split product, or a whole parameter each rank
    uses a slice of)."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelGroup]) -> torch.Tensor:
    """The partial products summed over the model ranks; identity backward."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def _halves(t: torch.Tensor, glu: bool):
    return t.chunk(2, dim=0) if glu else (t,)


def tp_slice(full: torch.Tensor, dim: int, glu: bool, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice along ``dim`` of a whole tensor (of each GLU
    half along dim 0)."""
    parts = [p.chunk(size, dim=dim)[rank] for p in _halves(full, glu)]
    return torch.cat(parts, dim=0).contiguous() if glu else parts[0].contiguous()


def tp_gather(local: torch.Tensor, dim: int, glu: bool, tp: ModelGroup) -> torch.Tensor:
    """Inverse of ``tp_slice`` (collective over the model ranks)."""
    out = []
    for part in _halves(local.contiguous(), glu):
        pieces = [torch.empty_like(part) for _ in range(tp.size)]
        dist.all_gather(pieces, part.contiguous(), group=tp.group)
        out.append(torch.cat(pieces, dim=dim))
    return torch.cat(out, dim=0) if glu else out[0]


def apply_tensor_parallel(model: nn.Module, tp: ModelGroup) -> None:
    """Split every encoder layer of ``model`` over the model ranks in place,
    each linear as ``parallel.sharding``'s rule table says, and record each
    split parameter in ``model.tp_splits`` (name -> (dim, glu)) and the
    group in ``model.tp_group``."""
    from unispeech_tpu_torch.models.encoder import TransformerEncoder, TransformerEncoderLayer
    from unispeech_tpu_torch.parallel.sharding import param_pspec

    splits = {}
    for prefix, m in model.named_modules():
        if isinstance(m, TransformerEncoder):
            m.tp = tp
        if not isinstance(m, TransformerEncoderLayer):
            continue
        attn = m.self_attn
        F_ = m.fc1.features if m.glu else m.fc1.out_features
        if attn.num_heads % tp.size or F_ % tp.size:
            raise ValueError(f"{attn.num_heads} heads and {F_} FFN units do not split "
                             f"over {tp.size} model ranks")
        for name, lin in m.named_modules():
            if not isinstance(lin, nn.Linear):
                continue
            spec = param_pspec(f"{name}.weight", tuple(lin.weight.shape), True, False)
            if "model" not in spec:
                continue
            dim, glu = spec.index("model"), name == "fc1.linear"
            with torch.no_grad():
                lin.weight = nn.Parameter(tp_slice(lin.weight, dim, glu, tp.rank, tp.size))
                splits[f"{prefix}.{name}.weight"] = (dim, glu)
                if dim == 0:  # a row-split linear adds its whole bias after the sum
                    lin.bias = nn.Parameter(tp_slice(lin.bias, 0, glu, tp.rank, tp.size))
                    splits[f"{prefix}.{name}.bias"] = (0, glu)
            lin.tp_split = (dim, tp)
        attn.num_heads //= tp.size
        attn.tp = tp
        if m.glu:
            m.fc1.features //= tp.size
        m.tp = tp
    model.tp_splits = splits
    model.tp_group = tp
