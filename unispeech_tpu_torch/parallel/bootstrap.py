"""Process-group bootstrap: one ``init_process_group`` per rank.

Counterpart of the JAX package's ``parallel/bootstrap.py``. JAX runs one
process per host over all of its devices; here a process drives one card,
so a run on N cards is N processes (launched by ``torchrun``, by SLURM's
``srun`` or by hand with ``--coordinator-address``, ``--num-processes`` and
``--process-id``). A plain single-process run builds no process group at
all.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_LOCAL_RANK: Optional[int] = None


def multihost_env_detected(environ=None) -> bool:
    """True when the environment says this is one process of several.

    Judged per source, as the JAX rule: SLURM's node count counts only when
    it is not "1", and torchrun's ``WORLD_SIZE`` only when it is above 1.
    The TPU-pod variables the JAX rule also reads
    (``MEGASCALE_COORDINATOR_ADDRESS``, ``TPU_WORKER_HOSTNAMES_OVERRIDE``)
    have no counterpart on GPUs and are not read."""
    env = os.environ if environ is None else environ
    return (env.get("SLURM_JOB_NUM_NODES", "1") != "1"
            or int(env.get("WORLD_SIZE", "1") or "1") > 1)


def _env_int(env, *names) -> Optional[int]:
    for name in names:
        if env.get(name):
            return int(env[name])
    return None


def resolve_launch(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, environ=None):
    """(address, world size, rank, local rank) of this process, or None for
    a plain single-process run. Explicit arguments come first, then
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/
    ``LOCAL_RANK``, then SLURM's ``SLURM_NTASKS``/``SLURM_PROCID``/
    ``SLURM_LOCALID``."""
    env = os.environ if environ is None else environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int(env, "WORLD_SIZE", "SLURM_NTASKS")
    if process_id is None:
        process_id = _env_int(env, "RANK", "SLURM_PROCID")
    if coordinator_address is None:
        if multihost_env_detected(env):
            raise ValueError(
                "a multi-process launch was detected but no coordinator address: pass "
                "--coordinator-address host:port or set MASTER_ADDR and MASTER_PORT")
        return None
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside a world of {num_processes}")
    local_rank = _env_int(env, "LOCAL_RANK", "SLURM_LOCALID")
    return coordinator_address, num_processes, process_id, local_rank


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device="cuda") -> bool:
    """Join the process group when this is one process of several.

    Arguments resolve as ``resolve_launch`` says; an explicit address is
    joined by ``tcp://``, one from ``MASTER_ADDR``/``MASTER_PORT`` by
    ``env://`` (under torchrun its agent already serves that port).
    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the
    CPU; a caller may name it (gloo carries CUDA tensors too, which lets
    two ranks share one card). The rank's card is ``cuda:{LOCAL_RANK}``
    (without it, the rank modulo the card count). Returns True when the
    group exists (also when it already did), False for a plain
    single-process run. Safe to call more than once."""
    global _LOCAL_RANK
    if dist.is_initialized():
        return True
    init_method = None if coordinator_address is None else f"tcp://{coordinator_address}"
    launch = resolve_launch(coordinator_address, num_processes, process_id)
    if launch is None:
        return False
    _, world, rank, local_rank = launch
    device = torch.device(device)
    if device.type == "cuda":
        if local_rank is None:
            local_rank = rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(local_rank)
    _LOCAL_RANK = local_rank
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank)
    return True


def rank_device(device) -> torch.device:
    """``device`` with a CUDA device bound to this rank's card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and _LOCAL_RANK is not None:
        return torch.device("cuda", _LOCAL_RANK)
    return device
