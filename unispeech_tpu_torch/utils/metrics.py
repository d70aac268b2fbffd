"""Metrics aggregation and progress logging (host).

Counterpart of the JAX package's ``utils/metrics.py``: the train step returns
metric sums (device scalars or host numbers); ``MetricsAggregator`` adds them
up between log intervals and derives averages; ``ProgressLogger`` writes JSON
lines to stderr and, where asked and installed, to TensorBoard, Weights &
Biases or Azure ML. An optional sink that fails to start is left out: it
never stops training.
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


def safe_round(x, digits: int = 3):
    if x is None:
        return None
    x = float(x)
    if math.isfinite(x):
        return round(x, digits)
    return x


class MetricsAggregator:
    """Per-step metric sums; at log time, ``loss_avg`` = loss / sample_size
    and the derived metrics added with ``add_derived``."""

    def __init__(self):
        self.sums: Dict[str, float] = defaultdict(float)
        self.n_steps = 0
        self._derived: Dict[str, Callable[[Dict[str, float]], float]] = {}
        self._t0 = time.time()

    def add_derived(self, name: str, fn: Callable[[Dict[str, float]], float]):
        self._derived[name] = fn

    def update(self, step_metrics: Dict) -> None:
        """Add one step's metrics; reading a device scalar waits for it."""
        for k, v in step_metrics.items():
            self.sums[k] += float(v)
        self.n_steps += 1

    def snapshot(self) -> Dict[str, float]:
        out = dict(self.sums)
        ss = max(out.get("sample_size", 0.0), 1.0)
        derived = {}
        if "loss" in out:
            derived["loss_avg"] = out["loss"] / ss
        for name, fn in self._derived.items():
            try:
                derived[name] = fn(out)
            except (KeyError, ZeroDivisionError):  # its inputs were not logged
                pass
        derived["steps"] = self.n_steps
        derived["elapsed_s"] = time.time() - self._t0
        if derived["elapsed_s"] > 0:
            derived["steps_per_s"] = self.n_steps / derived["elapsed_s"]
        out.update(derived)
        return out

    def reset(self) -> None:
        self.sums.clear()
        self.n_steps = 0
        self._t0 = time.time()


class ProgressLogger:
    """JSON-lines progress records, plus the optional sinks: TensorBoard
    (``tensorboard_dir``), Weights & Biases (``wandb_project``) and Azure ML
    (``azureml=True``), each only when its package imports and starts."""

    def __init__(self, tag: str = "train", tensorboard_dir: Optional[str] = None,
                 stream=None, wandb_project: Optional[str] = None, azureml: bool = False):
        self.tag = tag
        self.stream = stream or sys.stderr
        self._tb = self._wandb = self._aml = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # an optional sink: log and go on
                self._sink_failed("tensorboard", e)
        if wandb_project:
            try:
                import wandb

                if wandb.run is None:
                    wandb.init(project=wandb_project, reinit=False)
                self._wandb = wandb
            except Exception as e:  # an optional sink: log and go on
                self._sink_failed("wandb", e)
        if azureml:
            try:
                from azureml.core import Run

                self._aml = Run.get_context()
            except Exception as e:  # an optional sink: log and go on
                self._sink_failed("azureml", e)

    def _sink_failed(self, name: str, err: Exception) -> None:
        print(json.dumps({"tag": self.tag, "sink_disabled": name, "error": repr(err)}),
              file=self.stream, flush=True)

    def log(self, step: int, stats: Dict[str, float]) -> None:
        rec = {"tag": self.tag, "step": step}
        rec.update({k: safe_round(v) for k, v in stats.items()})
        print(json.dumps(rec), file=self.stream, flush=True)
        scalars = {k: float(v) for k, v in stats.items()
                   if isinstance(v, (int, float)) and math.isfinite(float(v))}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{self.tag}/{k}", v, step)
        if self._wandb is not None:
            self._wandb.log({f"{self.tag}/{k}": v for k, v in scalars.items()}, step=step)
        if self._aml is not None:
            for k, v in scalars.items():
                self._aml.log(f"{self.tag}/{k}", v)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class StopwatchMeter:
    """Accumulated start/stop intervals and their mean."""

    def __init__(self):
        self.sum = 0.0
        self.n = 0
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self, n: int = 1):
        if self._start is not None:
            self.sum += time.perf_counter() - self._start
            self.n += n
            self._start = None

    @property
    def avg(self) -> float:
        return self.sum / max(self.n, 1)
