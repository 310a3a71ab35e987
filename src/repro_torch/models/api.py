"""Uniform model protocol: family -> module dispatch (port of
`repro/models/api.py`).  Ported so far: the dense transformer (serving) and
the vision classifier (training)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError
from repro_torch.models import transformer, vit

_FAMILY = {"dense": transformer, "vision": vit}


def get_module(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise ConfigError(f"family {cfg.family!r}: not ported yet")
    return _FAMILY[cfg.family]


def zero_cache_slots(cache: dict, slots) -> dict:
    """Zero the given batch lanes of a decode cache in place and return it.
    Every cache leaf carries the batch axis at position 1 (KV
    [L,B,S,Hkv,hd]), so this is the slot-recycle invariant the
    ContinuousBatcher relies on, for any family the port adds later."""
    for c in cache.values():
        idx = torch.as_tensor(slots, dtype=torch.long, device=c.device)
        c[:, idx] = 0
    return cache
