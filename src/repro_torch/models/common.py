"""Shared building blocks (port of `repro/models/common.py`, serving subset).

Every block has (a) a ``*_defs`` function producing declarative ParamDefs and
(b) an ``*_apply`` function consuming the materialized params.  Norms,
attention and the SwiGLU product route through `repro_torch.kernels.ops`, so
CUDA tensors run the hand-written kernels and CPU tensors the plain
versions.  The plain products the JAX package leaves to XLA outside any
kernel (wq/wk/wv/wo, the MLP wo, the tied unembed) stay `torch.matmul`.

Numerics: this module turns TF32 off for matmuls and for cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), so every fp32 product on the
card runs in full fp32, as the reference does.

Ported so far: rmsnorm, rope, the cached (decode) branches of `attn_apply`,
the SwiGLU MLP, embedding and the tied unembedding.  The no-cache and
cross-attention branches need the full-sequence `flash_attention` kernel
and wait for the training slice; layernorm and GELU wait for the model
families that use them.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError, ShapeError
from repro_torch.kernels import ops as kops
from repro_torch.models.param import ParamDef

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig) -> dict:
    if cfg.norm != "rmsnorm":
        raise ConfigError(f"norm {cfg.norm!r}: not ported yet")
    return {"scale": ParamDef((cfg.d_model,), ("embed",), "ones")}


def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return kops.rms_norm(x, p["scale"])


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B,S,H,D]; positions [S] or [B,S].  Operation for operation the
    reference's: fp32 frequencies theta ** (-arange/half), fp32 angles."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq           # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, sliding window, prefix-LM, KV cache)
# --------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig) -> dict:
    if cfg.qkv_bias:
        raise ConfigError("qkv_bias: not ported yet")
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, hq * hd), ("embed", "heads")),
        "wk": ParamDef((d, hkv * hd), ("embed", "kv")),
        "wv": ParamDef((d, hkv * hd), ("embed", "kv")),
        "wo": ParamDef((hq * hd, d), ("heads", "embed")),
    }


def attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
               positions: torch.Tensor, layer_window: int = 0,
               prefix_len: int = 0, cache: dict, cache_pos,
               ring: bool = False):
    """The cached (decode) branches of the reference's `attn_apply`.
    Returns (out, cache).

    cache: {"k": [B,Smax,Hkv,hd], "v": ...} of ONE layer, written IN PLACE
    at `cache_pos` (the reference returns a new cache; the port saves the
    copy).  cache_pos is an int / 0-d tensor (aligned batch) or a [B] tensor
    (ragged continuous batching).  The write index is clamped to
    [0, Smax - S] exactly as JAX's `dynamic_update_slice` clamps it, so a
    retired slot sitting at position Smax writes row Smax-1 instead of
    indexing out of range; attention still uses the unclamped position.
    With ring=True the cache is a circular buffer shorter than the stream
    and keys carry their absolute positions for masking.
    """
    if cache is None:
        raise ConfigError("attn_apply without a cache is the full-sequence "
                          "path, which is not ported yet")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    ln = ck.shape[1]
    pos = torch.as_tensor(cache_pos, device=x.device)
    k_positions = None
    if pos.ndim > 0:                       # per-batch [B] (ragged)
        if ring:
            raise ShapeError("ragged positions + ring cache unsupported")
        start = pos.long().clamp(0, ln - s)
        rows = start[:, None] + torch.arange(s, device=x.device)  # [B,S]
        lanes = torch.arange(b, device=x.device)[:, None]
        ck[lanes, rows] = k.to(ck.dtype)
        cv[lanes, rows] = v.to(cv.dtype)
    else:
        p0 = int(pos)
        if ring:
            write = p0 % ln
            base = p0 - write
            idx = torch.arange(ln, device=x.device)
            k_positions = torch.where(idx <= write, base + idx,
                                      base - ln + idx)
        else:
            write = min(max(p0, 0), ln - s)
        ck[:, write:write + s] = k.to(ck.dtype)
        cv[:, write:write + s] = v.to(cv.dtype)
    o = kops.flash_attention(q, ck, cv, causal=True, window=layer_window,
                             prefix_len=prefix_len, q_offset=pos,
                             k_positions=k_positions)
    return o.reshape(b, s, hq * hd) @ p["wo"], cache


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act != "swiglu":
        raise ConfigError(f"activation {cfg.act!r}: not ported yet")
    return {"wi": ParamDef((d, f), ("embed", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "embed")),
            "wg": ParamDef((d, f), ("embed", "mlp"))}


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return kops.swiglu(x, p["wg"], p["wi"]) @ p["wo"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> dict:
    defs = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            "embed", scale=0.02)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return defs


def embed_apply(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    h = p["tok"][tokens]
    if cfg.embed_scale:
        # sqrt(d_model) cast to the activation dtype first, as the reference
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype).item()
    return h


def unembed_apply(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (h @ w.to(h.dtype)).float()


def stack_defs(defs, n: int):
    """Prepend a 'layers' axis of size n to every ParamDef in a tree."""
    return T.map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                    d.init, d.scale), defs)
