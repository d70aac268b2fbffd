"""The device check of the port's entry points.

Everything runs on the card unless the caller asks for the CPU; there is
no fallback.
"""

from __future__ import annotations

import torch


def device_or_raise(name) -> torch.device:
    """``name`` as a device; a CUDA device when none is present raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name}: no CUDA device is available (pass --device cpu, or "
            "device='cpu' from Python, to run on the CPU)")
    return device
