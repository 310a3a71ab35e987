"""Uniform model protocol: family -> module dispatch (port of
`repro/models/api.py`).

Every module exposes:
  param_defs(cfg) -> ParamDef tree
  loss_fn(cfg, params, batch, *, remat) -> scalar loss
  forward(cfg, params, ...) -> logits (the transformer: (logits, aux))
  cache_spec / init_cache / prefill / decode_step   (the LMs)

Ported: the dense transformer, the MoE transformer (`moe`: the same
module, routed experts in place of the MLP, their aux loss in `forward`'s
second output) and the prefix-LM (`vlm`: the same module,
`prefix_embeds` in the batch), the whisper encoder-decoder
(`audio`: `frames` in the batch, the encoder's memory in the cache) for
training, prefill and decode, the SSM mamba2 (`ssm`: conv and SSM state
in the cache) and the hybrid zamba2 (`hybrid`: that state nested under
"mamba" beside the shared block's KV), and the vision classifier
(training)."""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError
from repro_torch.models import mamba2, transformer, vit, whisper, zamba2

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "audio": whisper,
           "ssm": mamba2, "hybrid": zamba2, "vision": vit}


def get_module(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise ConfigError(f"family {cfg.family!r}: not ported yet")
    return _FAMILY[cfg.family]


def zero_cache_slots(cache: dict, slots) -> dict:
    """Zero the given batch lanes of a decode cache in place and return it.
    Every cache leaf of the decoder families carries the batch axis at
    position 1 (KV [L,B,S,Hkv,hd], mamba2's conv [L,B,K-1,C] and ssm
    [L,B,H,P,N], zamba2's nested under "mamba"), so this is the
    slot-recycle invariant the ContinuousBatcher relies on; the walk goes
    through nested dicts, as the reference's `jax.tree.map` does.
    Whisper's `memory` [B, enc_seq, D] breaks it; the service loop refuses
    audio configs."""
    for c in T.leaves(cache):
        idx = torch.as_tensor(slots, dtype=torch.long, device=c.device)
        c[:, idx] = 0
    return cache


def batch_keys(cfg: ModelConfig) -> tuple[str, ...]:
    """Input tensors a training batch must contain (besides labels)."""
    if cfg.family == "vlm":
        return ("tokens", "prefix_embeds")
    if cfg.family == "audio":
        return ("tokens", "frames")
    if cfg.family == "vision":
        return ("images",)
    return ("tokens",)
