"""Plain PyTorch versions of the kernels (port of `repro/kernels/ref.py`).

They define the semantics the CUDA kernels must match up to fp tolerance,
and they are what a CPU tensor runs (`kernels/ops.py`).  Here so far:
`rms_norm`, `_mask`, `attention` and `swiglu` (serving), `adamw_update`,
`sync_flat_update` and `sync_apply_update` (training), `ring_combine` and
`ring_quantize_codes` (the ring-int8 sync's per-hop requant pass), and the
port's own backward passes `rms_norm_bwd` and `swiglu_bwd` (the JAX
package differentiates `rms_norm` and `swiglu` by autodiff).

Each function mirrors the JAX oracle op for op (Python-float constants are
rounded to fp32 at the op, as JAX's weak types are), so on the CPU the two
agree to the last few ulps and the port's tree and flat layouts, which run
the same ops elementwise, agree bitwise.
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


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `rms_norm` for the output gradient dy [..., D], in fp32
    over rows: with r = rsqrt(mean(x^2) + eps) a row's,
    dx = r s dy - x r^3 mean(dy s x) and dscale = sum over rows of dy x r.
    Returns (dx [..., D] in x's dtype, dscale [D] in scale's)."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    g = dy.float().reshape(-1, d)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    gs = g * scale.float()
    dot = torch.mean(gs * xf, dim=-1, keepdim=True)
    dx = r * gs - xf * (r * r * r) * dot
    dscale = torch.sum(g * xf * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


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


def adamw_update(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay, step):
    """AdamW with bias correction; moments fp32, params kept in input dtype.
    `step` is the (1-based) update count: an int, a float or a 0-d tensor,
    taken as fp32 as the reference does.  Returns (new_p, new_m, new_v)."""
    gf = g.float()
    m1 = beta1 * m + (1.0 - beta1) * gf
    v1 = beta2 * v + (1.0 - beta2) * torch.square(gf)
    stepf = torch.as_tensor(step, dtype=torch.float32)
    bc1 = 1.0 - beta1 ** stepf
    bc2 = 1.0 - beta2 ** stepf
    upd = (m1 / bc1) / (torch.sqrt(v1 / bc2) + eps)
    pf = p.float()
    p1 = pf - lr * (upd + weight_decay * pf)
    return p1.to(p.dtype), m1, v1


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device.  On CUDA, torch turns a
    division by a Python scalar into a multiplication by its rounded
    reciprocal (and torch.mean multiplies by 1/N), which differs in the
    last bit; a 0-d tensor on x's device keeps the true division, which is
    what the CPU and the CUDA kernels compute."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker axis as sum / W.  On integer-valued codes
    the sum is exact in any order, so this is bitwise the same on the CPU,
    on the card and in the CUDA kernel."""
    return true_div(x.sum(0), float(x.shape[0]))


def quantize_codes(d: torch.Tensor, scale) -> torch.Tensor:
    """Integer codes clip(round(d/s*127)) in [-127, 127], kept in fp32.
    `torch.round` rounds halves to even, as `jnp.round` does."""
    return torch.clamp(torch.round(d / scale * 127.0), -127.0, 127.0)


def sync_flat_update(p, anchor, *, scale=None, mu=None, momentum=0.0):
    """Fused flat-buffer sync update (one pass in the kernel).

    p [W, N] worker replicas of one dtype bucket; anchor [N] params at the
    previous sync; scale [N] per-element (per-tensor, spread) int8 scales —
    None disables quantization; mu [N] fp32 outer-momentum buffer — used iff
    momentum > 0.  Returns (new_p [W, N], new_anchor [N], new_mu [N] | None).
    Quantized, the mean runs over the integer codes and is dequantized once
    after it (the reference's RS-domain rule)."""
    d = p.float() - anchor.float()[None]
    if scale is not None:
        step = mean0(quantize_codes(d, scale[None])) * true_div(scale, 127.0)
    else:
        step = mean0(d)
    new_anchor, new_mu = _outer_step(step, anchor, mu, momentum)
    new_p = new_anchor[None].expand(p.shape).to(p.dtype).contiguous()
    return new_p, new_anchor, new_mu


def sync_flat_update_lane_order(p, anchor, *, scale=None, mu=None,
                                momentum=0.0):
    """`sync_flat_update` with the worker sum taken lane by lane in the order
    0..W-1, one tensor op at a time: the CUDA kernel's order.  The
    unquantized mean sums fp32 deltas, whose bits depend on that order
    (`sync_flat_update` sums in torch's); on the card the kernel is bitwise
    this in every mode."""
    acc = None
    for lane in range(p.shape[0]):
        d = p[lane].float() - anchor.float()
        if scale is not None:
            d = quantize_codes(d, scale)
        acc = d if acc is None else acc + d
    step = true_div(acc, float(p.shape[0]))
    if scale is not None:
        step = step * true_div(scale, 127.0)
    new_anchor, new_mu = _outer_step(step, anchor, mu, momentum)
    new_p = new_anchor[None].expand(p.shape).to(p.dtype).contiguous()
    return new_p, new_anchor, new_mu


def sync_apply_update(step_in, anchor, *, scale=None, mu=None, momentum=0.0):
    """The gather-leg apply: dequantize the worker-mean codes (when `scale`
    is given), outer Nesterov, anchor update.  Returns (new_anchor,
    new_mu | None).  The op sequence after the mean is `sync_flat_update`'s,
    so the composed (tree) and fused (flat) syncs agree bitwise."""
    step = step_in * true_div(scale, 127.0) if scale is not None else step_in
    return _outer_step(step, anchor, mu, momentum)


def ring_combine(q, s, x, k: int):
    """One receive hop of the re-quantizing int8 ring.  q [n] int8 codes of
    the incoming partial mean over k contributors, s () the sender's
    guarded scale (a 0-d tensor on q's device), x [n] this worker's chunk.
    Folds x into the running MEAN, acc = (k * q * s/127 + x) / (k + 1), and
    returns (acc [n] f32, amax ()) with amax = max|acc|, the statistic the
    next hop's scale is guarded from.  Both divisions are IEEE divisions
    (`true_div`) on every device."""
    deq = q.float() * true_div(s, 127.0)
    acc = true_div(float(k) * deq + x.float(), float(k + 1))
    return acc, torch.max(torch.abs(acc))


def ring_quantize_codes(acc, scale):
    """int8 wire codes of a ring partial mean under ONE guarded scalar scale
    (a 0-d tensor): clip(round(acc/scale*127)) in [-127, 127], as int8."""
    return quantize_codes(acc.float(), scale).to(torch.int8)


def _outer_step(step, anchor, mu, momentum):
    new_mu = None
    if momentum > 0.0:
        new_mu = momentum * mu + step
        step = momentum * new_mu + step          # Nesterov
    return (anchor.float() + step).to(anchor.dtype), new_mu


def swiglu(x, wg, wi):
    """silu(x @ wg) * (x @ wi) in fp32, cast back to x.dtype."""
    xf = x.float()
    g = xf @ wg.float()
    u = xf @ wi.float()
    return (F.silu(g) * u).to(x.dtype)


def swiglu_fwd(x, wg, wi):
    """`swiglu` and the pair its backward reads: (out, p, q) with out
    bitwise `swiglu`'s, p = u sigma(g) (1 + g (1 - sigma(g))) (torch's
    `silu_backward` form) and q = silu(g) [..., F] fp32, so that dg = dh p
    and du = dh q."""
    xf = x.float()
    g = xf @ wg.float()
    u = xf @ wi.float()
    q = F.silu(g)
    sig = torch.sigmoid(g)
    return (q * u).to(x.dtype), u * sig * (1.0 + g * (1.0 - sig)), q


def swiglu_bwd(x, wg, wi, p, q, dh, need=(True, True, True)):
    """Gradients of `swiglu` from the pair `swiglu_fwd` returns, for the
    output gradient dh [..., F]: (dx [..., D], dwg [D, F], dwi [D, F]) in
    the operands' dtypes, fp32 inside, over x's rows flattened, with dg =
    dh p, du = dh q, dx = dg wg^T + du wi^T, dwg = x^T dg, dwi = x^T du
    (fp32 products, TF32 off); None for an operand `need` marks as needing
    none (its products do not run)."""
    d, f = wg.shape
    xf = x.float().reshape(-1, d)
    dhf = dh.float().reshape(-1, f)
    dg, du = dhf * p.reshape(-1, f), dhf * q.reshape(-1, f)
    dx = dwg = dwi = None
    if need[0]:
        dx = torch.addmm(dg @ wg.float().T, du, wi.float().T)
        dx = dx.reshape(x.shape).to(x.dtype)
    if need[1]:
        dwg = (xf.T @ dg).to(wg.dtype)
    if need[2]:
        dwi = (xf.T @ du).to(wi.dtype)
    return dx, dwg, dwi
