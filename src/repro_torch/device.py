"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  With no card
and no explicit CPU request they raise: nothing carries on silently on the
CPU.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ConfigError


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None or "cuda[:i]" -> a CUDA device (raises when there is no card);
    "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ConfigError(f"unsupported device {dev}")
