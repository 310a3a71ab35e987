"""Zamba2 — a Mamba2 backbone with one weight-shared attention block
(arXiv:2411.15242; port of `repro/models/zamba2.py`).

`n_layers` Mamba2 layers; after every `shared_attn_period` of them a
single *shared* (weight-tied) transformer block runs on the concatenation
of the hidden state and the original embedding, projected back to d_model
(Zamba's concat trick).  Parameters keep the reference's layout: the
backbone doubly stacked as `groups` [G, period, ...] plus a `tail` of the
`n_layers - G·period` layers left over, and one `shared` block whose
gradient collects all G uses through autograd.  The reference's nested
`lax.scan` becomes Python loops, its per-group `jax.checkpoint`
`torch.utils.checkpoint` (the tail is not rematerialised, as there).

The cache nests the mamba state, {"mamba": {"conv", "ssm"} over all L
mamba layers, "attn_k" / "attn_v" [G,B,S,Hkv,hd]} (one KV cache per use
of the shared block, capped by `window_override` and then a ring); every
leaf has its batch on axis 1.  On the card the shared block's attention
runs the `flash_attention` kernels (prefill and training) and
`flash_decode` (decode), every norm `rms_norm`; its GELU MLP stays plain
torch.  A decode step takes one position for the whole batch: the
reference's builds `positions = pos[None, None]`, which a per-slot [B]
position breaks, so the port raises up front (and the serving CLI's
`--slots` refuses the family).  Prompt lengths as in `models/mamba2.py`
(`check_prompt`).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ShapeError
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as m2
from repro_torch.models.param import ParamDef


def shared_block_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "in_proj": ParamDef((2 * d, d), ("embed", "embed")),
        "ln1": cm.norm_defs(cfg), "ln2": cm.norm_defs(cfg),
        "attn": cm.attn_defs(cfg),
        "mlp": cm.mlp_defs(cfg),
        "out_proj": ParamDef((d, d), ("embed", "embed")),
    }


def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    g = cfg.n_layers // cfg.shared_attn_period
    rem = cfg.n_layers - g * cfg.shared_attn_period
    return g, rem


def param_defs(cfg: ModelConfig) -> dict:
    g, rem = n_groups(cfg)
    mdefs = m2._layer_defs(cfg)
    defs = {
        "embed": cm.embed_defs(cfg),
        "groups": cm.stack_defs(cm.stack_defs(mdefs, cfg.shared_attn_period),
                                g),                  # [G, period, ...]
        "shared": shared_block_defs(cfg),            # weight-tied block
        "final_norm": cm.norm_defs(cfg),
    }
    if rem:
        defs["tail"] = cm.stack_defs(mdefs, rem)
    return defs


def _shared_apply(cfg, p, h, h0, *, positions, cache=None, cache_pos=None,
                  ring=False):
    x = torch.cat([h, h0], -1) @ p["in_proj"]
    a, nc = cm.attn_apply(cfg, p["attn"], cm.norm_apply(cfg, p["ln1"], x),
                          positions=positions, cache=cache,
                          cache_pos=cache_pos, ring=ring)
    x = x + a
    x = x + cm.mlp_apply(cfg, p["mlp"], cm.norm_apply(cfg, p["ln2"], x))
    return h + x @ p["out_proj"], nc


def _mamba_block(cfg, lp, h, cache=None):
    out, nc = m2.mixer_apply(cfg, lp["mixer"], cm.norm_apply(cfg, lp["ln"], h),
                             cache=cache)
    return h + out, nc


def _group(cfg, gp, shared, h, h0, positions):
    """One group of the full-sequence forward: `period` mamba layers, then
    the shared block (the unit remat recomputes)."""
    for li in range(cfg.shared_attn_period):
        h, _ = _mamba_block(cfg, T.map(lambda t: t[li], gp), h)
    h, _ = _shared_apply(cfg, shared, h, h0, positions=positions)
    return h


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            remat: bool = True):
    """tokens [B,S] -> (logits [B,S,V] fp32, aux 0)."""
    h0 = cm.embed_apply(cfg, params["embed"], tokens)
    positions = torch.arange(h0.shape[1], device=h0.device)
    g, rem = n_groups(cfg)
    h = h0
    for gi in range(g):
        gp = T.map(lambda t: t[gi], params["groups"])
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _group, cfg, gp, params["shared"], h, h0, positions,
                use_reentrant=False)
        else:
            h = _group(cfg, gp, params["shared"], h, h0, positions)
    for li in range(rem):
        h, _ = _mamba_block(cfg, T.map(lambda t: t[li], params["tail"]), h)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return cm.unembed_apply(cfg, params["embed"], h), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat=True):
    logits, _ = forward(cfg, params, batch["tokens"], remat=remat)
    return cm.lm_loss(logits, batch["labels"])


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               window_override: int = 0) -> dict:
    """{"mamba": mamba2's spec over all L layers, "attn_k" / "attn_v"
    [G,B,ln,Hkv,hd]}, ln = min(max_len, window_override) when the override
    is set (a ring buffer once shorter than the stream), else max_len."""
    g, _ = n_groups(cfg)
    ln = min(max_len, window_override) if window_override else max_len
    kv = (g, batch, ln, cfg.n_kv_heads, cfg.hd)
    return {"mamba": m2.cache_spec(cfg, batch, max_len),
            "attn_k": kv, "attn_v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.float32, device, window_override: int = 0) -> dict:
    spec = cache_spec(cfg, batch, max_len, window_override)
    return {"mamba": m2.init_cache(cfg, batch, max_len, dtype=dtype,
                                   device=device),
            "attn_k": torch.zeros(spec["attn_k"], dtype=dtype, device=device),
            "attn_v": torch.zeros(spec["attn_v"], dtype=dtype, device=device)}


def _cached_pass(cfg, params, h0, cache, *, positions, cache_pos, ring,
                 decode: bool):
    """The pass over groups and tail with caches, all written in place:
    each mamba layer's state (advanced a token in a decode step; the
    post-prompt state in a prefill) and each shared-block use's KV rows."""
    g, rem = n_groups(cfg)
    period = cfg.shared_attn_period
    mcache = cache["mamba"]
    h = h0

    def mamba(lp, h, idx):
        if decode:
            h, _ = _mamba_block(cfg, lp, h, cache={
                "conv": mcache["conv"][idx], "ssm": mcache["ssm"][idx]})
        else:
            h, nc = _mamba_block(cfg, lp, h)
            mcache["conv"][idx].copy_(nc["conv"])
            mcache["ssm"][idx].copy_(nc["ssm"])
        return h

    for gi in range(g):
        for li in range(period):
            h = mamba(T.map(lambda t: t[gi, li], params["groups"]), h,
                      gi * period + li)
        h, _ = _shared_apply(cfg, params["shared"], h, h0,
                             positions=positions,
                             cache={"k": cache["attn_k"][gi],
                                    "v": cache["attn_v"][gi]},
                             cache_pos=cache_pos, ring=ring)
    for li in range(rem):
        h = mamba(T.map(lambda t: t[li], params["tail"]), h, g * period + li)
    return h, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict, **_):
    """Full-sequence prefill of tokens [B,S] from position 0, filling the
    mamba state and the shared block's KV rows 0..S-1 in place.  S must be
    at least `ssm_conv - 1` and a length the SSD chunk `min(ssm_chunk, S)`
    divides (`mamba2.check_prompt`: ShapeError otherwise).  Returns (logits
    of the last position [B,V] fp32, cache)."""
    m2.check_prompt(cfg, tokens.shape[1])
    h0 = cm.embed_apply(cfg, params["embed"], tokens)
    positions = torch.arange(h0.shape[1], device=h0.device)
    h, cache = _cached_pass(cfg, params, h0, cache, positions=positions,
                            cache_pos=0, ring=False, decode=False)
    h = cm.norm_apply(cfg, params["final_norm"], h[:, -1:].contiguous())
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, *, prefix_len: int = 0, ring: bool = False):
    """One decode step: token [B] at position `pos`, one int (or 0-d
    tensor) for the whole batch; ring=True on a ring KV cache.  A per-slot
    [B] position raises ShapeError (module docstring).  Updates `cache` in
    place; returns (logits [B,V] fp32, cache)."""
    del prefix_len
    h0 = cm.embed_apply(cfg, params["embed"], token[:, None])
    pos_t = torch.as_tensor(pos, device=h0.device)
    if pos_t.ndim > 0:
        raise ShapeError(
            f"{cfg.name}: decode_step takes one position for the batch, got "
            f"shape {tuple(pos_t.shape)}; the reference's zamba2 decode "
            "builds positions pos[None, None] and cannot take per-slot "
            "positions")
    h, cache = _cached_pass(cfg, params, h0, cache,
                            positions=pos_t[None, None], cache_pos=pos,
                            ring=ring, decode=True)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache
