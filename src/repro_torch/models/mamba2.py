"""Mamba2 — SSD (state-space duality), arXiv:2405.21060 (port of
`repro/models/mamba2.py`).

Chunked SSD: within a chunk the sequence mixing is a masked quadratic form,
across chunks a state recurrence carries it, O(S·Q) in place of O(S^2).
Decode is one state update a token: the conv keeps the last `ssm_conv - 1`
raw input rows, the SSM its [H, P, N] state.

Parameters keep the reference's stacked `[L, ...]` layout; its `lax.scan`
over layers (and over chunks) becomes a Python loop, its per-layer
`jax.checkpoint` `torch.utils.checkpoint`.  No kernel is the SSM's own:
the SSD contractions, the depthwise causal conv and the softplus stay
plain torch, as the reference leaves them to XLA outside any Pallas
kernel; on the card the gated norm `rms_norm(y * silu(z))` and every
layer norm run the `rms_norm` kernel (under autograd its `_RmsNorm`
Function and the `rms_norm_bwd` kernel).

One deliberate numerical divergence: the intra-chunk decay matrix masks
its upper triangle to -inf before the `exp` (the reference takes
`where(tri, exp(li), 0)`).  Above the diagonal `li` is positive and, past
~47 tokens a chunk at the configs' init, overflows fp32; the reference's
forward drops those entries but its gradient turns them into 0 · inf =
NaN (at `ssm_chunk` = 256, d/d dt).  Here `exp(-inf)` is exactly 0: the
forward's values are the reference's, and the gradient is the
reference's wherever that one is finite, and finite where it is NaN.

Shapes the family takes (both packages): a full-sequence pass splits the
sequence into chunks of `min(ssm_chunk, S)` and raises `ShapeError` when
that does not divide S; a prefill needs at least `ssm_conv - 1` prompt
tokens to fill the conv state (the port raises up front; the reference
fails at the first decode step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ShapeError
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models.param import ParamDef


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def mixer_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, h, conv_dim = dims(cfg)
    return {
        "wz": ParamDef((d, d_inner), ("embed", "mlp")),
        "wxBC": ParamDef((d, conv_dim), ("embed", "conv_dim")),
        "wdt": ParamDef((d, h), ("embed", "heads")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), (None, "conv_dim")),
        "conv_b": ParamDef((conv_dim,), ("conv_dim",), "zeros"),
        "A_log": ParamDef((h,), ("heads",), "ones"),
        "dt_bias": ParamDef((h,), ("heads",), "zeros"),
        "D": ParamDef((h,), ("heads",), "ones"),
        "norm": ParamDef((d_inner,), ("mlp",), "ones"),
        "wout": ParamDef((d_inner, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x [B,S,C], w [K,C]: out[t] = b + sum_k
    x[t + k - (K-1)] w[k], x zero before the sequence (the reference's
    left-padded VALID conv), as K shifted products."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = w.to(x.dtype)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b.to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _intra_chunk(cum, Cc, Bc, dtc, xc):
    """Within each chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j)
    dt_j x_j, the decay masked to -inf above the diagonal before the exp."""
    q = cum.shape[-1]
    li = cum[..., :, None] - cum[..., None, :]                    # [B,nc,H,Qi,Qj]
    tri = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    L = torch.exp(li.masked_fill(~tri, float("-inf")))
    scores = Cc @ Bc.transpose(-1, -2)                            # [B,nc,1,Qi,Qj]
    M = scores * L * dtc[..., None, :]                            # weight by dt_j
    return M @ xc


def ssd_chunked(x, dt, A, B_, C_, D, chunk: int, initial_state=None):
    """SSD over a full sequence.

    x [B,S,H,P]; dt [B,S,H] (>0); A [H] (<0); B_,C_ [B,S,N]; D [H].
    Returns (y [B,S,H,P], final_state [B,H,P,N] fp32).  The reference's
    contractions, laid out head-major ([B,nc,H,Q,·]) so each is one batched
    matmul; the decay mask goes in before the exp (module docstring)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q != 0:
        raise ShapeError(f"seq len {s} not divisible by chunk {q}")
    nc = s // q
    f32 = torch.float32

    xc = x.reshape(b, nc, q, h, p).to(f32).permute(0, 1, 3, 2, 4)  # [B,nc,H,Q,P]
    dtc = dt.reshape(b, nc, q, h).to(f32).permute(0, 1, 3, 2)     # [B,nc,H,Q]
    Bc = B_.reshape(b, nc, q, n).to(f32)[:, :, None]              # [B,nc,1,Q,N]
    Cc = C_.reshape(b, nc, q, n).to(f32)[:, :, None]
    a = dtc * A.to(f32)[:, None]                                  # negative
    cum = torch.cumsum(a, -1)                                     # [B,nc,H,Q]

    # ---- intra-chunk: masked quadratic form ----
    ins = (cum, Cc, Bc, dtc, xc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        # its [B,nc,H,Q,Q] tensors are recomputed in the backward, not
        # kept: at the full configs' chunk they would be the largest
        # activations of a layer (300 MB a layer at mamba2-130m's 4 x 1024
        # tokens); the values and gradients are the same
        y_intra = torch.utils.checkpoint.checkpoint(_intra_chunk, *ins,
                                                    use_reentrant=False)
    else:
        y_intra = _intra_chunk(*ins)                              # [B,nc,H,Q,P]

    # ---- chunk-final states ----
    dec_end = torch.exp(cum[..., -1:] - cum)                      # [B,nc,H,Q]
    s_c = ((dec_end * dtc)[..., None] * xc).transpose(-1, -2) @ Bc  # [B,nc,H,P,N]
    chunk_dec = torch.exp(cum[..., -1])                           # [B,nc,H]

    # ---- inter-chunk recurrence (the reference's lax.scan) ----
    hprev = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    h_in = []
    for c in range(nc):
        h_in.append(hprev)                                        # entering chunk c
        hprev = hprev * chunk_dec[:, c, :, None, None] + s_c[:, c]
    h_in = torch.stack(h_in, 1)                                   # [B,nc,H,P,N]

    y_inter = (Cc @ h_in.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), hprev


def mixer_apply(cfg: ModelConfig, p: dict, u: torch.Tensor, *,
                cache: dict | None = None, initial_state=None):
    """u [B,S,d_model] -> (out [B,S,d_model], cache).

    cache (decode, S must be 1): {"conv": [B,K-1,Cd], "ssm": [B,H,P,N]} of
    ONE layer, advanced by the token IN PLACE (the reference returns new
    arrays) and returned.  Without a cache: the full-sequence SSD from
    `initial_state` (zeros by default), and the returned dict holds the
    post-sequence state, {"conv": the last K-1 raw (pre-conv) xBC rows,
    "ssm": the final state}, as new tensors."""
    b, s, _ = u.shape
    d_inner, h, _ = dims(cfg)
    n, pdim = cfg.ssm_state, cfg.ssm_headdim
    f32 = torch.float32
    z = u @ p["wz"]
    xBC = u @ p["wxBC"]
    dt_raw = u @ p["wdt"] + p["dt_bias"].to(u.dtype)
    dt = _softplus(dt_raw.to(f32))
    A = -torch.exp(p["A_log"].to(f32))

    if cache is not None:
        if s != 1:
            raise ShapeError(f"cached mixer step takes one token, got {s}")
        window = torch.cat([cache["conv"].to(xBC.dtype), xBC], 1)  # [B,K,Cd]
        conv_out = (torch.einsum("bkc,kc->bc", window.to(f32),
                                 p["conv_w"].to(f32))
                    + p["conv_b"].to(f32))[:, None]
        xBC_c = F.silu(conv_out).to(u.dtype)
        xs = xBC_c[..., :d_inner].reshape(b, 1, h, pdim)
        B_ = xBC_c[..., d_inner:d_inner + n]
        C_ = xBC_c[..., d_inner + n:]
        # single-step state update
        dt0 = dt[:, 0, :]                                          # [B,H]
        x0 = xs[:, 0].to(f32)                                      # [B,H,P]
        dec = torch.exp(dt0 * A[None])
        upd = (dt0[..., None] * x0)[..., None] * B_[:, 0].to(f32)[:, None, None]
        hs = cache["ssm"].to(f32) * dec[:, :, None, None] + upd
        y = (hs @ C_[:, 0].to(f32)[:, None, :, None])[..., 0]      # [B,H,P]
        y = y + x0 * p["D"].to(f32)[None, :, None]
        y = y.reshape(b, 1, d_inner).to(u.dtype)
        cache["conv"].copy_(window[:, 1:])
        cache["ssm"].copy_(hs)
        new_cache = cache
    else:
        xBC_c = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xs = xBC_c[..., :d_inner].reshape(b, s, h, pdim)
        B_ = xBC_c[..., d_inner:d_inner + n]
        C_ = xBC_c[..., d_inner + n:]
        y, final = ssd_chunked(xs, dt, A, B_, C_, p["D"], cfg.ssm_chunk,
                               initial_state=initial_state)
        y = y.reshape(b, s, d_inner)
        new_cache = {"conv": xBC[:, -(cfg.ssm_conv - 1):, :], "ssm": final}

    y = kops.rms_norm(y * F.silu(z), p["norm"])
    return y @ p["wout"], new_cache


# --------------------------------------------------------------------------
# Full mamba2 LM
# --------------------------------------------------------------------------

def _layer_defs(cfg: ModelConfig) -> dict:
    return {"ln": cm.norm_defs(cfg), "mixer": mixer_defs(cfg)}


def param_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": cm.embed_defs(cfg),
        "layers": cm.stack_defs(_layer_defs(cfg), cfg.n_layers),
        "final_norm": cm.norm_defs(cfg),
    }


def _layer(cfg, lp, h):
    """One residual mixer layer of the full-sequence forward: the unit
    remat recomputes."""
    out, _ = mixer_apply(cfg, lp["mixer"], cm.norm_apply(cfg, lp["ln"], h))
    return h + out


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            remat: bool = True, prefix_embeds=None):
    """tokens [B,S] -> (logits [B,S,V] fp32, aux 0).  prefix_embeds
    [B,P,D] go before the embedded tokens and their positions' logits are
    dropped, as the reference's."""
    h = cm.embed_apply(cfg, params["embed"], tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], 1)
    for layer in range(cfg.n_layers):
        lp = T.map(lambda t: t[layer], params["layers"])
        if remat:
            h = torch.utils.checkpoint.checkpoint(_layer, cfg, lp, h,
                                                  use_reentrant=False)
        else:
            h = _layer(cfg, lp, h)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    if prefix_embeds is not None:
        h = h[:, prefix_embeds.shape[1]:]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return cm.unembed_apply(cfg, params["embed"], h), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, remat=True):
    logits, _ = forward(cfg, params, batch["tokens"], remat=remat)
    return cm.lm_loss(logits, batch["labels"])


# --------------------------------------------------------------------------
# Serving: conv and SSM state, prefill, single-token decode
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               window_override: int = 0) -> dict[str, tuple[int, ...]]:
    """State shapes: O(1) in the sequence length (max_len and
    window_override do not enter).  Every leaf has its batch on axis 1."""
    del max_len, window_override
    _, h, conv_dim = dims(cfg)
    l = cfg.n_layers
    return {"conv": (l, batch, cfg.ssm_conv - 1, conv_dim),
            "ssm": (l, batch, h, cfg.ssm_headdim, cfg.ssm_state)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.float32, device, window_override: int = 0) -> dict:
    """Zero state; the conv rows in `dtype`, the SSM state in fp32 always
    (the reference's)."""
    spec = cache_spec(cfg, batch, max_len, window_override)
    return {"conv": torch.zeros(spec["conv"], dtype=dtype, device=device),
            "ssm": torch.zeros(spec["ssm"], dtype=torch.float32,
                               device=device)}


def check_prompt(cfg: ModelConfig, s: int) -> None:
    """ShapeError unless a prefill can take s prompt tokens: at least
    `ssm_conv - 1` (the conv state's rows) and a length the SSD chunk
    `min(ssm_chunk, s)` divides."""
    if s < cfg.ssm_conv - 1:
        raise ShapeError(
            f"prompt of {s} tokens: {cfg.name} prefills at least ssm_conv - 1 "
            f"= {cfg.ssm_conv - 1} tokens to fill its conv state (the "
            "reference fails on the first decode step)")
    q = min(cfg.ssm_chunk, s)
    if s % q != 0:
        raise ShapeError(f"seq len {s} not divisible by chunk {q}: "
                         f"{cfg.name} prefills at most ssm_chunk = "
                         f"{cfg.ssm_chunk} tokens or a multiple of it")


def _scan_cached(cfg, params, h, cache):
    """The decode step's loop over layers: layer l advances the l-th slice
    of the stacked conv and SSM state in place."""
    for layer in range(cfg.n_layers):
        lp = T.map(lambda t: t[layer], params["layers"])
        out, _ = mixer_apply(cfg, lp["mixer"],
                             cm.norm_apply(cfg, lp["ln"], h),
                             cache={"conv": cache["conv"][layer],
                                    "ssm": cache["ssm"][layer]})
        h = h + out
    return h, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            cache: dict, **_):
    """Full-sequence prefill of tokens [B,S]: the cache (its contents
    ignored, as the reference's) becomes the post-prompt conv and SSM
    state, in place.  S must be at least `ssm_conv - 1`, and `min(ssm_chunk,
    S)` must divide it (`check_prompt`: ShapeError otherwise).  Returns
    (logits of the last position [B,V] fp32, cache)."""
    check_prompt(cfg, tokens.shape[1])
    h = cm.embed_apply(cfg, params["embed"], tokens)
    for layer in range(cfg.n_layers):
        lp = T.map(lambda t: t[layer], params["layers"])
        out, nc = mixer_apply(cfg, lp["mixer"],
                              cm.norm_apply(cfg, lp["ln"], h))
        h = h + out
        cache["conv"][layer].copy_(nc["conv"])
        cache["ssm"][layer].copy_(nc["ssm"])
    h = cm.norm_apply(cfg, params["final_norm"], h[:, -1:].contiguous())
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, token: torch.Tensor,
                cache: dict, pos, *, prefix_len: int = 0, ring: bool = False):
    """One token [B] through every layer; the state carries all history,
    so pos, prefix_len and ring are ignored (a ragged [B] pos from the
    continuous batcher too).  Updates `cache` in place; returns (logits
    [B,V] fp32, cache)."""
    del pos, prefix_len, ring
    h = cm.embed_apply(cfg, params["embed"], token[:, None])
    h, cache = _scan_cached(cfg, params, h, cache)
    h = cm.norm_apply(cfg, params["final_norm"], h)
    return cm.unembed_apply(cfg, params["embed"], h)[:, 0], cache
