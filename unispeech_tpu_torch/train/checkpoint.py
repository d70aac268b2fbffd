"""Checkpoints of a train state in ``torch.save`` form.

Counterpart of the JAX package's ``train/checkpoint.py`` (orbax there).
Each checkpoint is a directory ``{directory}/{step}`` holding
``state.pt`` (the model's state dict, the optimizer's AdamW moments and
update count, the train step, the data iterator's state) and ``meta.json``
({"step", "metrics"}: the best-metric score the save carried, if any). A
save writes a temporary directory and renames it into place, so a
checkpoint directory is always whole.

Pruning keeps the last ``keep_last`` steps for resuming and, beside them,
the best step by ``best_metric`` for model selection (fairseq's
checkpoint_last/checkpoint_best cadence, the JAX package's preservation
policy). A save without the metric (no validation ran since the last save)
scores as the worst value, so it never becomes best. A second save of an
existing step is skipped, as orbax skips it. The flat-``.npz`` params
export stays in ``convert/from_jax.py`` (``save_params_npz``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

STATE_FILE, META_FILE = "state.pt", "meta.json"


class CheckpointManager:
    """keep-N update checkpoints + the best one, in ``directory``."""

    def __init__(self, directory: str, keep_last: int = 3, best_metric: Optional[str] = "loss",
                 maximize_best: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.best_metric = best_metric
        self.maximize_best = maximize_best
        # step -> metrics, read back from the checkpoints already there
        self._metrics: Dict[int, Dict[str, float]] = {}
        for step in self.all_steps():
            with open(os.path.join(self._path(step), META_FILE)) as f:
                self._metrics[step] = json.load(f)["metrics"]

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Steps of the whole checkpoints in the directory, ascending."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self._path(int(n)),
                                                                     META_FILE)))

    def _score(self, step: int) -> float:
        """Larger is better; a step without the metric scores -inf."""
        value = self._metrics.get(step, {}).get(self.best_metric)
        if value is None:
            return float("-inf")
        return value if self.maximize_best else -value

    def save(self, step: int, state, data_state: Optional[Dict] = None,
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """Save ``state`` (a TrainState) at ``step``; returns False, saving
        nothing, when that step is already saved."""
        if step in self._metrics:
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.adamw.state_dict(),
            "optimizer_count": state.optimizer.count,
            "step": state.step,
            "data": data_state,
        }
        tmp = self._path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump({"step": step, "metrics": metrics}, f)
        os.replace(tmp, self._path(step))
        self._metrics[step] = metrics
        self._prune()
        return True

    def _prune(self) -> None:
        if not self.keep_last:
            return
        steps = sorted(self._metrics)
        keep = set(steps[-self.keep_last:])
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._path(step))
                del self._metrics[step]

    def restore(self, state, step: Optional[int] = None) -> Tuple[Optional[Dict], int]:
        """Load the checkpoint at ``step`` (default: the latest) into
        ``state`` in place, onto the devices its tensors are on. Returns
        (data_state, step), or (None, 0) when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, 0
        device = next(state.model.parameters()).device
        payload = torch.load(os.path.join(self._path(step), STATE_FILE),
                             map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.adamw.load_state_dict(payload["optimizer"])
        state.optimizer.count = payload["optimizer_count"]
        state.step = payload["step"]
        return payload["data"], step

    def latest_step(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None

    def best_step(self) -> Optional[int]:
        """The step with the best value of the tracked metric, the latest of
        equals; None while no checkpoint carries the metric."""
        scored = [s for s in self._metrics if self._score(s) > float("-inf")]
        return max(scored, key=lambda s: (self._score(s), s)) if scored else None
