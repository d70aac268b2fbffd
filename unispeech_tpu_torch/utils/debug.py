"""Non-finite localisation and a hung-step watchdog (host).

Counterpart of the JAX package's ``utils/debug.py`` (``nonfinite_paths``,
``HangWatchdog``). Its ``CompileWatchdog`` warns when a jitted step keeps
recompiling; eager PyTorch compiles nothing, so it has no counterpart here.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
from typing import List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def nonfinite_paths(state: Mapping[str, torch.Tensor],
                    max_report: int = 10) -> List[Tuple[str, str]]:
    """[(name, "nan" | "inf")] of the floating tensors of a state dict that
    hold a NaN or an Inf, at most ``max_report``."""
    out: List[Tuple[str, str]] = []
    for name, t in state.items():
        if len(out) >= max_report:
            break
        if not (torch.is_tensor(t) and t.is_floating_point()):
            continue
        if bool(torch.isnan(t).any()):
            out.append((name, "nan"))
        elif bool(torch.isinf(t).any()):
            out.append((name, "inf"))
    return out


class HangWatchdog:
    """Arm a timer around each step; when it fires, dump every thread's
    stack and either warn or end the process with exit code 17, so that an
    orchestrator restarts from the last checkpoint."""

    def __init__(self, timeout_s: float = 600.0, kill: bool = False):
        self.timeout_s = timeout_s
        self.kill = kill
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self.fired = 0

    def _on_timeout(self) -> None:
        self.fired += 1
        logger.error("step exceeded %.0fs: dumping stacks%s", self.timeout_s,
                     " and aborting" if self.kill else "")
        faulthandler.dump_traceback(file=sys.stderr)
        if self.kill:
            os._exit(17)

    def arm(self) -> None:
        with self._lock:
            self._cancel_locked()
            self._timer = threading.Timer(self.timeout_s, self._on_timeout)
            self._timer.daemon = True
            self._timer.start()

    def disarm(self) -> None:
        with self._lock:
            self._cancel_locked()

    def _cancel_locked(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
