"""Shared building blocks (port of `repro/models/common.py`).

Every block has (a) a ``*_defs`` function producing declarative ParamDefs and
(b) an ``*_apply`` function consuming the materialized params.  Norms,
attention and the SwiGLU product route through `repro_torch.kernels.ops`, so
CUDA tensors run the hand-written kernels and CPU tensors the plain
versions.  The plain products the JAX package leaves to XLA outside any
kernel (wq/wk/wv/wo, the MLP wi/wo, the tied unembed) stay `torch.matmul`,
and layernorm and GELU, which it computes in plain `jnp`, stay plain torch.

Numerics: this module turns TF32 off for matmuls and for cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`), so every fp32 product on the
card runs in full fp32, as the reference does.

Ported so far: rmsnorm and layernorm, rope, every branch of `attn_apply`
(decode with a cache, full-sequence self-attention, cross-attention) with
the optional QKV bias (qwen: `bq`, `bk`, `bv` added after the projections,
before rope, in plain torch, as the reference leaves them to XLA) and its
`_attn_chunked` query blocking, the SwiGLU and GELU MLPs, embedding, the
tied unembedding and the untied `head`, and `lm_loss`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    if cfg.norm == "layernorm":
        return {"scale": ParamDef((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamDef((cfg.d_model,), ("embed",), "zeros")}
    if cfg.norm != "rmsnorm":
        raise ConfigError(f"norm {cfg.norm!r}: not ported yet")
    return {"scale": ParamDef((cfg.d_model,), ("embed",), "ones")}


def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        # the reference's op order: population variance as mean((x-mu)^2),
        # rsqrt(var + 1e-6), fp32 inside, cast back
        xf = x.float()
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6)
        out = out * p["scale"].float() + p["bias"].float()
        return out.to(x.dtype)
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
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, hq * hd), ("embed", "heads")),
        "wk": ParamDef((d, hkv * hd), ("embed", "kv")),
        "wv": ParamDef((d, hkv * hd), ("embed", "kv")),
        "wo": ParamDef((hq * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((hq * hd,), ("heads",), "zeros")
        defs["bk"] = ParamDef((hkv * hd,), ("kv",), "zeros")
        defs["bv"] = ParamDef((hkv * hd,), ("kv",), "zeros")
    return defs


def _attn_chunked(q, k, v, *, causal, window, prefix_len, q_offset,
                  q_block=512):
    """Block the query dim so the [Sq,Sk] score tile stays bounded: query
    blocks of the largest divisor of Sq at most `q_block`, each at its own
    q_offset (the reference's scan, as a loop).  Only the plain version
    holds that tile: the CUDA kernel streams the keys tile by tile and
    computes each query row alone, so on the card the whole query range is
    one launch, with the same rows as the blocks would give."""
    b, sq, hq, hd = q.shape
    if sq <= q_block or q.device.type == "cuda":
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    prefix_len=prefix_len, q_offset=q_offset)
    while sq % q_block:
        q_block -= 1
    outs = [kops.flash_attention(
        q[:, i:i + q_block].contiguous(), k, v, causal=causal, window=window,
        prefix_len=prefix_len, q_offset=q_offset + i)
        for i in range(0, sq, q_block)]
    return torch.cat(outs, 1)


def attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
               positions: torch.Tensor, layer_window: int = 0,
               prefix_len: int = 0, cache: dict | None = None,
               cache_pos=None, ring: bool = False,
               kv_source: torch.Tensor | None = None, use_rope: bool = True):
    """Returns (out, new_cache).

    kv_source: if given, cross-attention — keys/values from this tensor, no
    rope, no causal mask, no cache.  cache None and no kv_source: full-
    sequence causal self-attention (sliding `layer_window`, bidirectional
    `prefix_len`).  Both run through `_attn_chunked`, so on the card they
    take the differentiable `flash_attention` kernel.

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
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_source is None else kv_source
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (src @ p["wk"]).reshape(b, src.shape[1], hkv, hd)
    v = (src @ p["wv"]).reshape(b, src.shape[1], hkv, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(hq, hd)
        k = k + p["bk"].reshape(hkv, hd)
        v = v + p["bv"].reshape(hkv, hd)
    if use_rope and kv_source is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_source is not None or cache is None:
        cross = kv_source is not None
        o = _attn_chunked(q, k, v, causal=not cross,
                          window=0 if cross else layer_window,
                          prefix_len=0 if cross else prefix_len, q_offset=0)
        return o.reshape(b, s, hq * hd) @ p["wo"], None

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
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act not in ("swiglu", "gelu"):
        raise ConfigError(f"activation {cfg.act!r}: not ported yet")
    defs = {"wi": ParamDef((d, f), ("embed", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "embed"))}
    if cfg.act == "swiglu":
        defs["wg"] = ParamDef((d, f), ("embed", "mlp"))
    return defs


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return kops.swiglu(x, p["wg"], p["wi"]) @ p["wo"]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]


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


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32. logits [..,S,V], labels [..,S]
    (the reference's op order: logsumexp minus the gold logit)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def stack_defs(defs, n: int):
    """Prepend a 'layers' axis of size n to every ParamDef in a tree."""
    return T.map(lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                                    d.init, d.scale), defs)
