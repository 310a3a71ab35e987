"""Decoder-only transformer LM (port of `repro/models/transformer.py`).

Covers the dense family: gemma3-4b (rmsnorm + SwiGLU, 5:1 local:global
windows), starcoder2-3b (layernorm + GELU, every layer windowed),
phi3-medium-14b (an untied head) and qwen1.5-110b (QKV bias); the MoE
family, dbrx-132b and kimi-k2-1t (`cfg.n_experts`: the FFN is
`models/moe.py`'s routed experts, whose load-balance aux loss every layer
adds to the objective); and the prefix-LM paligemma-3b (the `vlm`
family): `prefix_embeds [B,P,D]` (stub image embeddings) go before the
embedded tokens, attended bidirectionally (`prefix_len = P`), and only
the text positions' logits come out.
Parameters keep the reference's stacked `[L, ...]` layout; the reference's
`lax.scan` over layers becomes a Python loop over those stacked tensors,
with each layer's sliding window as a Python int, and its `jax.checkpoint`
per layer (remat) becomes `torch.utils.checkpoint`.  `forward`/`loss_fn`
train, `prefill` fills a KV cache from the prefix and prompt in one
full-sequence pass (on the card the `flash_attention` kernel), and
`decode_step` extends it by one token (the `flash_decode` kernel), with
the prefix's `prefix_len`.  `moe_shards` chooses the MoE dispatch of
training (`models/moe.py`); serving takes the global one.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod


def _layer_defs(cfg: ModelConfig) -> dict:
    d = {"ln1": cm.norm_defs(cfg), "ln2": cm.norm_defs(cfg),
         "attn": cm.attn_defs(cfg)}
    if cfg.n_experts > 0:
        d["moe"] = moe_mod.moe_defs(cfg)
    else:
        d["mlp"] = cm.mlp_defs(cfg)
    return d


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": cm.embed_defs(cfg),
        "layers": cm.stack_defs(_layer_defs(cfg), cfg.n_layers),
        "final_norm": cm.norm_defs(cfg),
    }


def _windows(cfg: ModelConfig) -> list[int]:
    return [cfg.layer_window(i) for i in range(cfg.n_layers)]


def _block(cfg, p, h, *, positions, window, prefix_len, cache, cache_pos,
           ring=False, moe_shards=1):
    """One layer: (h, aux, cache), aux the MoE layer's load-balance loss
    (None for a dense one: no tensor, no launch)."""
    a, cache = cm.attn_apply(
        cfg, p["attn"], cm.norm_apply(cfg, p["ln1"], h), positions=positions,
        layer_window=window, prefix_len=prefix_len, cache=cache,
        cache_pos=cache_pos, ring=ring)
    h = h + a
    hn = cm.norm_apply(cfg, p["ln2"], h)
    if cfg.n_experts > 0:
        f, aux = moe_mod.moe_apply(cfg, p["moe"], hn, shards=moe_shards)
    else:
        f, aux = cm.mlp_apply(cfg, p["mlp"], hn), None
    return h + f, aux, cache


def _embed(cfg, params, tokens, prefix_embeds):
    """(h [B,P+S,D], P): the prefix embeddings, cast to the activations'
    dtype, before the embedded tokens."""
    h = cm.embed_apply(cfg, params["embed"], tokens)
    if prefix_embeds is None:
        return h, 0
    return torch.cat([prefix_embeds.to(h.dtype), h], 1), prefix_embeds.shape[1]


def _layer(cfg, lp, h, positions, window, prefix_len, moe_shards):
    """One layer of the full-sequence forward (no cache): the unit remat
    recomputes.  Returns (h, aux)."""
    return _block(cfg, lp, h, positions=positions, window=window,
                  prefix_len=prefix_len, cache=None, cache_pos=None,
                  moe_shards=moe_shards)[:2]


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            prefix_embeds=None, remat=True, moe_shards: int = 1):
    """Full-sequence forward. tokens [B,S] int -> (logits [B,S,V] fp32,
    aux_loss): aux the sum over the layers of the MoE load-balance loss,
    0 for the dense family.  prefix_embeds [B,P,D]: a bidirectional prefix
    before the tokens (paligemma's image tokens); the logits are the text
    positions' only.  remat: each layer's activations are recomputed in
    the backward (`torch.utils.checkpoint`), as the reference's
    `jax.checkpoint` does; the recomputed layer routes its tokens as the
    first pass did (`models/moe.py`)."""
    h, prefix_len = _embed(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer, window in enumerate(_windows(cfg)):
        lp = T.map(lambda t: t[layer], params["layers"])
        args = (cfg, lp, h, positions, window, prefix_len, moe_shards)
        if remat:
            h, a = torch.utils.checkpoint.checkpoint(_layer, *args,
                                                     use_reentrant=False)
        else:
            h, a = _layer(*args)
        if a is not None:
            aux = aux + a
    h = cm.norm_apply(cfg, params["final_norm"], h)
    if prefix_len:
        h = h[:, prefix_len:]
    return cm.unembed_apply(cfg, params["embed"], h), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat=True,
            moe_shards: int = 1):
    """batch {"tokens", "labels"} [B,S] (and, for a VLM, "prefix_embeds"
    [B,P,D]) -> mean next-token loss over the text plus
    `router_aux_coef` times the MoE aux loss (0-d)."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          prefix_embeds=batch.get("prefix_embeds"),
                          remat=remat, moe_shards=moe_shards)
    return cm.lm_loss(logits, batch["labels"]) + cfg.router_aux_coef * aux


# --------------------------------------------------------------------------
# Serving: KV cache, prefill, single-token decode
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
    place.  An MoE layer runs the global dispatch and its aux loss is
    dropped, as the reference's serve path does."""
    for layer, window in enumerate(_windows(cfg)):
        lp = T.map(lambda t: t[layer], params["layers"])
        h, _, _ = _block(cfg, lp, h, positions=positions, window=window,
                         prefix_len=prefix_len,
                         cache={"k": cache["k"][layer],
                                "v": cache["v"][layer]},
                         cache_pos=cache_pos, ring=ring)
    return h, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict, *, prefix_embeds=None):
    """Run the prompt tokens [B,S] through the model, filling the cache from
    position 0 (in place): after prefix_embeds [B,P,D] where given (a
    VLM's image tokens, attended bidirectionally, cache rows 0..P-1; the
    decode steps then take `prefix_len=P`).  On CUDA tensors every
    attention runs the full-sequence `flash_attention` kernel, every norm
    `rms_norm` (an RMSNorm model's) and every SwiGLU MLP `swiglu` (over
    B·(P+S) rows; of an MoE layer only the shared expert: the routed
    experts are batched products over the capacity buffer).  Returns
    (logits of the last position [B,V] fp32, cache)."""
    h, prefix_len = _embed(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    h, cache = _scan_cached(cfg, params, h, positions=positions,
                            prefix_len=prefix_len, cache=cache, cache_pos=0)
    h = cm.norm_apply(cfg, params["final_norm"], h[:, -1:].contiguous())
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, *, prefix_len: int = 0, ring: bool = False):
    """One decode step. token [B] int; pos an int (aligned batch) or an int
    tensor [B] (ragged continuous batching — each slot writes/attends at its
    own position).  ring=True: the cache is a circular buffer shorter than
    the stream.  On CUDA tensors every RMSNorm runs the `rms_norm` kernel,
    every attention the `flash_decode` kernel and every SwiGLU MLP (an MoE
    layer's shared expert) the `swiglu` kernel; an MoE layer's capacity of
    at least 8 rows runs every expert on every step.  Updates `cache` in
    place; returns (logits [B,V] fp32, cache)."""
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
