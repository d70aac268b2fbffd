"""The ("data", "model") mesh, the parameter rules, and the full layout.

Counterpart of the JAX package's ``parallel/sharding.py``. Ranks form a
(n_data, n_model) grid, row-major: global rank = data rank * n_model +
model rank. Along "data" each rank takes its own rows of the batch (the
iterators' ``num_shards``/``shard_id`` are n_data and the data rank, so the
model ranks of one data rank see the same batch) and, with FSDP, holds a
shard of each parameter (``fully_shard``, dim 0). Along "model" the encoder
layers split their heads and FFN as the rule table says (``param_pspec``;
``tensor_parallel.py`` does it). Optimizer moments follow their parameter.

Checkpoints and exports use the full layout: ``full_state_dict`` gathers
every tensor whole in the unsharded model's keys, and
``load_full_state_dict`` cuts a full state dict down to this rank's pieces,
so a checkpoint of any mesh loads on any other, one process included.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

_MESH = None  # the mesh of this process (make_mesh), None without one


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda"):
    """The ("data", "model") ``DeviceMesh`` over all ranks; n_data defaults
    to world size // n_model, and n_data * n_model must be the world size.
    Without a process group, a world of one is made (no network), so FSDP
    runs in one process too."""
    global _MESH
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (n_data, n_model, world)
    _MESH = init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))
    return _MESH


def data_rank() -> int:
    """This process's row of the mesh (0 without a mesh)."""
    return _MESH.get_local_rank("data") if _MESH is not None else 0


def model_rank() -> int:
    """This process's column of the mesh (0 without a mesh)."""
    return _MESH.get_local_rank("model") if _MESH is not None else 0


def data_size() -> int:
    return _MESH["data"].size() if _MESH is not None else 1


def model_size() -> int:
    return _MESH["model"].size() if _MESH is not None else 1


# (name regex, spec) in the port's (out, in) layout, first match wins; the
# JAX table's (in, out) kernels transposed. q/k/v and fc1 split their output
# rows (heads, FFN units), out_proj and fc2 their input columns; a GLU fc1
# splits each of its two halves (tensor_parallel.py).
_TP_RULES = [
    (r".*fc1\.weight$", ("model", None)),
    (r".*fc1\.bias$", ("model",)),
    (r".*fc1\.linear\.weight$", ("model", None)),
    (r".*fc1\.linear\.bias$", ("model",)),
    (r".*fc2\.weight$", (None, "model")),
    (r".*(q_proj|k_proj|v_proj)\.weight$", ("model", None)),
    (r".*(q_proj|k_proj|v_proj)\.bias$", ("model",)),
    (r".*out_proj\.weight$", (None, "model")),
]


def param_pspec(name: str, shape: Sequence[int], tensor_parallel: bool, fsdp: bool,
                n_data: int = 1) -> Tuple:
    """Per dim of parameter ``name``: None (whole), "model", "data", or
    ("model", "data") for a dim the model axis splits and FSDP then shards.
    FSDP (``fully_shard``) shards dim 0 of every parameter of the model,
    padding a dim that n_data does not divide; all else is replicated."""
    spec = [None] * len(shape)
    if tensor_parallel:
        for pat, rule in _TP_RULES:
            if re.match(pat, name):
                spec = list(rule)
                break
    if fsdp and n_data > 1 and len(shape):
        spec[0] = "data" if spec[0] is None else (spec[0], "data")
    return tuple(spec)


def shard_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Move this rank's local batch to ``device``. Its iterator already took
    this data rank's rows (JAX assembles a global array from the local
    batches here; each rank keeps its own), and the leading microbatch axes
    (accum, inner steps) are whole."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def local_rows(batch: Dict, n_stack: int = 0) -> Dict:
    """This data rank's contiguous block of rows of a global batch (axis
    ``n_stack``): what its iterator shard would hand it."""
    n, r = data_size(), data_rank()

    def cut(v):
        B = v.shape[n_stack]
        if B % n:
            raise ValueError(f"{B} rows do not split over {n} data ranks")
        idx = (slice(None),) * n_stack + (slice(r * B // n, (r + 1) * B // n),)
        return v[idx]

    return {k: cut(v) for k, v in batch.items()}


# -- the full layout ----------------------------------------------------------

def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The local piece of a DTensor (sharing its storage), else ``t``."""
    return t._local_tensor if is_dtensor(t) else t


def _full(t: torch.Tensor, split, tp) -> torch.Tensor:
    from unispeech_tpu_torch.parallel.tensor_parallel import tp_gather

    if is_dtensor(t):
        t = t.full_tensor()
    if split is not None:
        t = tp_gather(t, *split, tp)
    return t


def _local_of(full: torch.Tensor, like: torch.Tensor, split, tp) -> torch.Tensor:
    from unispeech_tpu_torch.parallel.tensor_parallel import tp_slice

    if split is not None:
        full = tp_slice(full, *split, tp.rank, tp.size)
    full = full.to(device=like.device, dtype=like.dtype)
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        full = distribute_tensor(full, like.device_mesh, like.placements, src_data_rank=None)
    return full


def _splits(model: nn.Module):
    return getattr(model, "tp_splits", {}), getattr(model, "tp_group", None)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every tensor whole, in the unsharded
    model's keys (collective: every rank calls it and gets it)."""
    splits, tp = _splits(model)
    return {k: _full(v, splits.get(k), tp) for k, v in model.state_dict().items()}


def full_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Each trainable parameter's gradient whole, by name (collective)."""
    splits, tp = _splits(model)
    return {k: _full(p.grad, splits.get(k), tp) for k, p in model.named_parameters()
            if p.requires_grad and p.grad is not None}


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a full state dict into a model sharded any way (strict keys)."""
    splits, tp = _splits(model)
    own = model.state_dict()
    missing, unexpected = set(own) - set(state), set(state) - set(own)
    if missing or unexpected:
        raise KeyError(f"state dict keys differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    with torch.no_grad():
        for k, dst in own.items():
            dst.copy_(_local_of(state[k], dst, splits.get(k), tp))


def _trainable_names(model: nn.Module, params) -> list:
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    if len(names) != len(params):
        raise ValueError("the optimizer's parameters are not the model's trainable ones")
    return names


def full_optimizer_state(model: nn.Module, adamw: torch.optim.Optimizer, params) -> Dict:
    """``adamw.state_dict()`` with each moment whole (collective)."""
    names, (splits, tp) = _trainable_names(model, params), _splits(model)
    sd = adamw.state_dict()
    state = {i: {k: _full(v, splits.get(names[i]), tp) if torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state(model: nn.Module, adamw: torch.optim.Optimizer, params,
                              sd: Dict) -> None:
    """Load a full ``full_optimizer_state`` into ``adamw`` over its (maybe
    sharded) ``params``."""
    names, (splits, tp) = _trainable_names(model, params), _splits(model)
    state = {i: {k: _local_of(v, params[i], splits.get(names[i]), tp)
                 if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
             for i, st in sd["state"].items()}
    adamw.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
