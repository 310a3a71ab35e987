"""Plain PyTorch versions of the kernels (port of `repro/kernels/ref.py`).

They define the semantics the CUDA kernels must match up to fp tolerance,
and they are what a CPU tensor runs (`kernels/ops.py`).  Only the
functions on the serving path are here so far: `rms_norm`, `_mask`,
`attention` and `swiglu`.  The training slice adds the optimizer and sync
ones.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.errors import ShapeError

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def _mask(sq: int, sk: int, *, causal: bool, window: int, prefix_len: int,
          q_offset, k_positions=None, device=None) -> torch.Tensor:
    """Returns bool [sq,sk] — or [B,sq,sk] when q_offset is a per-batch
    tensor [B] (ragged continuous-batching decode)."""
    q_offset = torch.as_tensor(q_offset, device=device).long()
    if q_offset.ndim == 1:                      # per-batch offsets [B]
        q_offset = q_offset[:, None, None]
        lead = (q_offset.shape[0], sq, sk)
    else:
        lead = (sq, sk)
    q_idx = torch.arange(sq, device=device)[:, None] + q_offset
    if k_positions is not None:
        k_idx = torch.as_tensor(k_positions, device=device).long()[None, :]
        valid = k_idx >= 0                      # ring positions, -1 = empty
    else:
        k_idx = torch.arange(sk, device=device)[None, :]
        valid = torch.ones((1, sk), dtype=torch.bool, device=device)
    ok = valid.expand(lead)
    if causal:
        ok = ok & (k_idx <= q_idx)
    if window > 0:
        ok = ok & (k_idx > q_idx - window)
    if prefix_len:
        ok = ok | (valid & (k_idx < prefix_len))  # bidirectional prefix
    return ok


def attention(q, k, v, *, causal=True, window=0, prefix_len=0, q_offset=0,
              scale=None, k_positions=None):
    """q [B,Sq,Hq,D]; k,v [B,Sk,Hkv,D]; GQA via head-group broadcast (query
    head h reads kv head h // g).  A row with no valid key gets uniform
    weights, i.e. the mean of V over the Sk keys, exactly as the JAX
    reference does (its masked scores are the finite -1e30)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ShapeError(f"GQA needs Hq % Hkv == 0, got ({hq}, {hkv})")
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    m = _mask(sq, sk, causal=causal, window=int(window),
              prefix_len=prefix_len, q_offset=q_offset,
              k_positions=k_positions, device=q.device)
    if m.ndim == 3:   # per-batch mask [B,sq,sk] (ragged decode)
        s = torch.where(m[:, None, None], s, NEG_INF)
    else:
        s = torch.where(m[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def swiglu(x, wg, wi):
    """silu(x @ wg) * (x @ wi) in fp32, cast back to x.dtype."""
    xf = x.float()
    g = xf @ wg.float()
    u = xf @ wi.float()
    return (F.silu(g) * u).to(x.dtype)
