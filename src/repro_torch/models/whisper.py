"""Whisper encoder-decoder backbone (port of `repro/models/whisper.py`).

The mel-spectrogram and conv frontend is a stub in both packages: the
model takes precomputed frame embeddings `frames [B, enc_seq, D]` (whisper-
base: 1500 frames).  The encoder attends bidirectionally over them (no
rope: the keys and values are the normed h, the cross branch of
`attn_apply`); the decoder is causal self-attention with rope (the
reference's stand-in for whisper's learned positions), cross-attention on
the encoder's output `memory`, and a GELU MLP, every norm a layernorm.

Parameters keep the reference's stacked `enc_layers` / `dec_layers` trees;
its `lax.scan` over layers becomes a Python loop, and its per-layer
`jax.checkpoint` (remat) `torch.utils.checkpoint`.  `forward` / `loss_fn`
train on `batch["frames"]`; `prefill` encodes the frames (or reads the
cached memory) and fills the decoder's KV cache from the prompt; and
`decode_step` extends it by one token, its cross-attention recomputing the
keys and values from `memory` every step, as the reference does.  No
kernel is whisper's own: on the card every attention runs the
`flash_attention` kernels (the decoder's decode-step self-attention
`flash_decode`), and layernorm and GELU stay plain torch.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def _enc_layer_defs(cfg: ModelConfig) -> dict:
    return {"ln1": cm.norm_defs(cfg), "ln2": cm.norm_defs(cfg),
            "attn": cm.attn_defs(cfg), "mlp": cm.mlp_defs(cfg)}


def _dec_layer_defs(cfg: ModelConfig) -> dict:
    return {"ln1": cm.norm_defs(cfg), "ln2": cm.norm_defs(cfg),
            "ln3": cm.norm_defs(cfg), "attn": cm.attn_defs(cfg),
            "xattn": cm.attn_defs(cfg), "mlp": cm.mlp_defs(cfg)}


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": cm.embed_defs(cfg),
        "enc_layers": cm.stack_defs(_enc_layer_defs(cfg), cfg.n_enc_layers),
        "enc_norm": cm.norm_defs(cfg),
        "dec_layers": cm.stack_defs(_dec_layer_defs(cfg), cfg.n_layers),
        "final_norm": cm.norm_defs(cfg),
    }


def _layer(stack: dict, i: int) -> dict:
    return T.map(lambda t: t[i], stack)


def _enc_layer(cfg, lp, h, positions):
    """One encoder layer: bidirectional self-attention (keys and values
    from the same normed h, through the cross branch), then the MLP."""
    hn = cm.norm_apply(cfg, lp["ln1"], h)
    a, _ = cm.attn_apply(cfg, lp["attn"], hn, positions=positions,
                         use_rope=False, kv_source=hn)
    h = h + a
    return h + cm.mlp_apply(cfg, lp["mlp"], cm.norm_apply(cfg, lp["ln2"], h))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames [B, enc_seq, D] (the stub frontend's output) -> memory
    [B, enc_seq, D]."""
    h = frames
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params["enc_layers"], i)
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _enc_layer, cfg, lp, h, positions, use_reentrant=False)
        else:
            h = _enc_layer(cfg, lp, h, positions)
    return cm.norm_apply(cfg, params["enc_norm"], h)


def _dec_block(cfg, lp, h, memory, *, positions, cache=None, cache_pos=None,
               ring=False):
    a, cache = cm.attn_apply(cfg, lp["attn"], cm.norm_apply(cfg, lp["ln1"], h),
                             positions=positions, cache=cache,
                             cache_pos=cache_pos, ring=ring)
    h = h + a
    x, _ = cm.attn_apply(cfg, lp["xattn"], cm.norm_apply(cfg, lp["ln2"], h),
                         positions=positions, kv_source=memory)
    h = h + x
    hn = cm.norm_apply(cfg, lp["ln3"], h)
    return h + cm.mlp_apply(cfg, lp["mlp"], hn), cache


def _dec_layer(cfg, lp, h, memory, positions):
    """One decoder layer of the teacher-forced forward: the unit remat
    recomputes."""
    return _dec_block(cfg, lp, h, memory, positions=positions)[0]


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            frames: torch.Tensor, remat: bool = True):
    """Teacher-forced forward: tokens [B,S] int, frames [B, enc_seq, D] ->
    (logits [B,S,V] fp32, aux 0)."""
    memory = encode(cfg, params, frames, remat=remat)
    h = cm.embed_apply(cfg, params["embed"], tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                _dec_layer, cfg, lp, h, memory, positions,
                use_reentrant=False)
        else:
            h = _dec_layer(cfg, lp, h, memory, positions)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return cm.unembed_apply(cfg, params["embed"], h), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat=True):
    """batch {"tokens", "labels"} [B,S] and "frames" [B, enc_seq, D] ->
    mean next-token loss (0-d)."""
    logits, _ = forward(cfg, params, batch["tokens"], frames=batch["frames"],
                        remat=remat)
    return cm.lm_loss(logits, batch["labels"])


# --------------------------------------------------------------------------
# Serving: KV cache and memory, prefill, single-token decode
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               window_override: int = 0) -> dict[str, tuple[int, ...]]:
    """The decoder's KV cache [L, B, ln, Hkv, hd], ln = min(max_len,
    window_override) when the override is set (a ring buffer), and the
    encoder's output `memory` [B, enc_seq, D].  `memory` has its batch on
    axis 0, so `api.zero_cache_slots` does not apply: the service loop
    refuses audio configs."""
    ln = min(max_len, window_override) if window_override else max_len
    kv = (cfg.n_layers, batch, ln, cfg.n_kv_heads, cfg.hd)
    return {"k": kv, "v": kv, "memory": (batch, cfg.enc_seq, cfg.d_model)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.float32, device, window_override: int = 0) -> dict:
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in cache_spec(cfg, batch, max_len,
                                          window_override).items()}


def _scan_cached(cfg, params, h, memory, *, positions, cache, cache_pos,
                 ring=False):
    """The reference's scan over decoder layers, as a loop: layer l writes
    the l-th cache slice in place."""
    for i in range(cfg.n_layers):
        h, _ = _dec_block(cfg, _layer(params["dec_layers"], i), h, memory,
                          positions=positions,
                          cache={"k": cache["k"][i], "v": cache["v"][i]},
                          cache_pos=cache_pos, ring=ring)
    return h


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict, *, frames: torch.Tensor | None = None):
    """Encode `frames` [B, enc_seq, D] into the cache's `memory` (or, with
    none given, read the memory already there), then run the prompt tokens
    [B,S] through the decoder, filling its cache from position 0 (all in
    place).  Returns (logits of the last position [B,V] fp32, cache)."""
    if frames is not None:
        memory = encode(cfg, params, frames.to(cache["memory"].dtype),
                        remat=False)
        cache["memory"].copy_(memory)
    memory = cache["memory"]
    h = cm.embed_apply(cfg, params["embed"], tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _scan_cached(cfg, params, h, memory.to(h.dtype), positions=positions,
                     cache=cache, cache_pos=0)
    h = cm.norm_apply(cfg, params["final_norm"], h[:, -1:].contiguous())
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, *, prefix_len: int = 0, ring: bool = False):
    """One decode step at position `pos` (an int): token [B] int ->
    (logits [B,V] fp32, cache), the cache updated in place.  `prefix_len`
    is taken for the uniform protocol and ignored (an audio model has no
    prefix); ring=True: the KV cache is a circular buffer shorter than the
    stream."""
    del prefix_len
    h = cm.embed_apply(cfg, params["embed"], token[:, None])
    pos = torch.as_tensor(pos, device=h.device)
    h = _scan_cached(cfg, params, h, cache["memory"].to(h.dtype),
                     positions=pos[None, None], cache=cache, cache_pos=pos,
                     ring=ring)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache
