"""Decoder-only transformer LM, serving path (port of
`repro/models/transformer.py`).

Covers the dense rmsnorm + SwiGLU + GQA family (gemma3-4b).  Parameters
keep the reference's stacked `[L, ...]` layout; the reference's `lax.scan`
over layers becomes a Python loop over those stacked tensors, with each
layer's sliding window as a Python int.  `forward`/`loss_fn` (training) and
the full-sequence `prefill` wait for the training slice; the serving path
feeds prompts through `decode_step` one token at a time.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError
from repro_torch.models import common as cm


def _layer_defs(cfg: ModelConfig) -> dict:
    if cfg.n_experts > 0:
        raise ConfigError(f"{cfg.name}: MoE layers are not ported yet")
    return {"ln1": cm.norm_defs(cfg), "ln2": cm.norm_defs(cfg),
            "attn": cm.attn_defs(cfg), "mlp": cm.mlp_defs(cfg)}


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": cm.embed_defs(cfg),
        "layers": cm.stack_defs(_layer_defs(cfg), cfg.n_layers),
        "final_norm": cm.norm_defs(cfg),
    }


def _windows(cfg: ModelConfig) -> list[int]:
    return [cfg.layer_window(i) for i in range(cfg.n_layers)]


def _block(cfg, p, h, *, positions, window, prefix_len, cache, cache_pos,
           ring=False):
    a, cache = cm.attn_apply(
        cfg, p["attn"], cm.norm_apply(cfg, p["ln1"], h), positions=positions,
        layer_window=window, prefix_len=prefix_len, cache=cache,
        cache_pos=cache_pos, ring=ring)
    h = h + a
    hn = cm.norm_apply(cfg, p["ln2"], h)
    return h + cm.mlp_apply(cfg, p["mlp"], hn), cache


# --------------------------------------------------------------------------
# Serving: KV cache, single-token decode
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               window_override: int = 0) -> dict[str, tuple[int, ...]]:
    """KV cache shapes.  window_override>0 caps every layer's cache at the
    longest window needed (or the override for full-attention layers) and
    serves it as a ring buffer; 0 holds the full stream."""
    if window_override > 0:
        ln = max(min(max_len, cfg.layer_window(i) or window_override)
                 for i in range(cfg.n_layers))
    else:
        ln = max_len
    kv = (cfg.n_layers, batch, ln, cfg.n_kv_heads, cfg.hd)
    return {"k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.float32, device, window_override: int = 0) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in cache_spec(cfg, batch, max_len,
                                          window_override).items()}


def _scan_cached(cfg, params, h, *, positions, prefix_len, cache, cache_pos,
                 ring=False):
    """The reference's scan over layers, as a loop: layer l reads the l-th
    slice of every stacked parameter and writes the l-th cache slice in
    place."""
    for layer, window in enumerate(_windows(cfg)):
        lp = T.map(lambda t: t[layer], params["layers"])
        h, _ = _block(cfg, lp, h, positions=positions, window=window,
                      prefix_len=prefix_len,
                      cache={"k": cache["k"][layer], "v": cache["v"][layer]},
                      cache_pos=cache_pos, ring=ring)
    return h, cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, *, prefix_len: int = 0, ring: bool = False):
    """One decode step. token [B] int; pos an int (aligned batch) or an int
    tensor [B] (ragged continuous batching — each slot writes/attends at its
    own position).  ring=True: the cache is a circular buffer shorter than
    the stream.  On CUDA tensors every norm runs the `rms_norm` kernel,
    every attention the `flash_decode` kernel and every MLP the `swiglu`
    kernel.  Updates `cache` in place; returns (logits [B,V] fp32, cache)."""
    h = cm.embed_apply(cfg, params["embed"], token[:, None])
    pos = torch.as_tensor(pos, device=h.device)
    if pos.ndim > 0:
        pos = pos.to(torch.int32)
    positions = pos[None, None] if pos.ndim == 0 else pos[:, None]
    h, cache = _scan_cached(cfg, params, h, positions=positions,
                            prefix_len=prefix_len, cache=cache,
                            cache_pos=pos, ring=ring)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache
