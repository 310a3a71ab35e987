"""Kernel entry points the models call, dispatched by the tensor's device.

The port of `repro/kernels/ops.py`, without its env-var backend switch:

  * a CPU tensor takes the plain PyTorch version (`kernels/ref.py`);
  * a CUDA tensor launches the hand-written CUDA kernel, or raises.

There is no fallback from the kernel to the plain version: a failed build or
launch on the card is an exception.  Where autograd needs a gradient, the
card's `rms_norm`, `swiglu` and full-sequence `flash_attention` run as
`torch.autograd.Function`s whose backward is a kernel too (`rms_norm_bwd`,
`swiglu_bwd`, `flash_attention_bwd`); without one they launch the forward
kernel alone, as serving does.  On the CPU autograd differentiates the plain
versions.  Models call these; they never touch a kernel module directly.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels import adamw_update as _ad
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import swiglu as _sw
from repro_torch.kernels import sync_update as _su

# every kernel launcher, by the name its launch count is reported under
KERNELS = {"rms_norm": _rn.rms_norm, "swiglu": _sw.swiglu,
           "rms_norm_bwd": _rn.rms_norm_bwd, "swiglu_bwd": _sw.swiglu_bwd,
           "flash_decode": _fa.flash_decode,
           "flash_attention_fwd": _fa.flash_attention_fwd,
           "flash_attention_bwd": _fa.flash_attention_bwd,
           "adamw_update": _ad.adamw_update,
           "sync_flat_update": _su.sync_flat_update,
           "sync_apply_update": _su.sync_apply_update,
           "ring_combine": _su.ring_combine,
           "ring_quantize": _su.ring_quantize}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _su.reset_bf16_launches()


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ConfigError(f"{op}: no kernel for device {t.device}")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """On CUDA under autograd the differentiable `_RmsNorm` (the
    `rms_norm_bwd` kernel in the backward), else the forward kernel."""
    if _on_cuda(x, "rms_norm"):
        if _needs_grad(x, scale):
            return _rn.rms_norm_autograd(x, scale, eps)
        return _rn.rms_norm(x, scale, eps)
    return ref.rms_norm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0, q_offset=0, scale: float | None = None,
                    k_positions=None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] (GQA by head broadcast).

    On the card, single-query causal decode without a gradient runs the
    `flash_decode` kernel (runtime ragged offsets and ring positions); every
    other call with a scalar q_offset and no ring positions runs the
    differentiable full-sequence `flash_attention` kernel.  Anything else
    (a ragged or ring full-sequence call) raises."""
    if not _on_cuda(q, "flash_attention"):
        return ref.attention(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len, q_offset=q_offset,
                             scale=scale, k_positions=k_positions)
    if q.shape[1] == 1 and causal and not _needs_grad(q, k, v):
        return _fa.flash_decode(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len, q_offset=q_offset,
                                scale=scale, k_positions=k_positions)
    ragged = isinstance(q_offset, torch.Tensor) and q_offset.ndim > 0
    if k_positions is None and not ragged:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len,
                                   q_offset=int(q_offset), scale=scale)
    raise ConfigError("flash_attention on CUDA: ragged offsets and ring "
                      "positions run only single-query causal decode")


def swiglu(x, wg, wi):
    """Fused silu(x@wg)*(x@wi) — the MLP hot spot.  On CUDA under autograd
    the differentiable `_SwiGLU` (the forward kernel keeping the pair its
    backward reads, and the two `swiglu_bwd` product launches in the
    backward), else the forward kernel."""
    if _on_cuda(x, "swiglu"):
        if _needs_grad(x, wg, wi):
            return _sw.swiglu_autograd(x, wg, wi)
        return _sw.swiglu(x, wg, wi)
    return ref.swiglu(x, wg, wi)


# the plain AdamW runs on the CPU in chunks of this many elements, so its
# dozen elementwise passes stay in cache (the same bits: each element's
# arithmetic is its own); about twice as fast on a leaf of 1e8 elements
CPU_ADAMW_CHUNK = 1 << 20


def adamw_update(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay, step):
    """Fused AdamW update for one tensor.  Returns (new_p, new_m, new_v): on
    CUDA the kernel updates p, m, v in place and returns them; on the CPU the
    plain version returns new tensors."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step)
    if _on_cuda(p, "adamw_update"):
        return _ad.adamw_update(p, m, v, g, **kw)
    n = p.numel()
    if n <= CPU_ADAMW_CHUNK or not all(
            t.is_contiguous() and t.shape == p.shape for t in (m, v, g)):
        return ref.adamw_update(p, m, v, g, **kw)
    outs = (torch.empty_like(p), torch.empty(m.shape, dtype=torch.float32),
            torch.empty(v.shape, dtype=torch.float32))
    flat = [t.reshape(-1) for t in (p, m, v, g)]
    out_flat = [t.view(-1) for t in outs]
    for i in range(0, n, CPU_ADAMW_CHUNK):
        part = ref.adamw_update(*(t[i:i + CPU_ADAMW_CHUNK] for t in flat),
                                **kw)
        for o, r in zip(out_flat, part):
            o[i:i + CPU_ADAMW_CHUNK] = r
    return outs


def sync_flat_update(p, anchor, *, scale=None, mu=None, momentum: float = 0.0):
    """Fused flat-bucket sync (delta -> int8 codes -> worker mean -> Nesterov
    -> anchor, broadcast to the W lanes) in one pass.  Returns (new_p,
    new_anchor, new_mu | None): in place on CUDA, new tensors on the CPU."""
    kw = dict(scale=scale, mu=mu, momentum=momentum)
    if _on_cuda(p, "sync_flat_update"):
        return _su.sync_flat_update(p, anchor, **kw)
    return ref.sync_flat_update(p, anchor, **kw)


def sync_apply_update(step_in, anchor, *, scale=None, mu=None,
                      momentum: float = 0.0):
    """The gather-leg apply of the split sync: dequantize the worker-mean
    codes (when `scale` is given), outer Nesterov, new anchor.  Returns NEW
    (anchor, mu | None) on every device: the inputs are left as they are."""
    kw = dict(scale=scale, mu=mu, momentum=momentum)
    if _on_cuda(step_in, "sync_apply_update"):
        return _su.sync_apply_update(step_in, anchor, **kw)
    return ref.sync_apply_update(step_in, anchor, **kw)


def ring_combine(q, s, x, k: int):
    """One receive hop of the int8 ring: (acc, amax) with acc = (k * q *
    s/127 + x) / (k + 1) and amax = max|acc| (a 0-d tensor on q's
    device)."""
    if _on_cuda(q, "ring_combine"):
        return _su.ring_combine(q, s, x, k)
    return ref.ring_combine(q, s, x, k)


def ring_quantize_codes(acc, scale):
    """Send-side half of the per-hop requant pass: int8 codes of a ring
    partial mean under one scalar scale (a 0-d tensor)."""
    if _on_cuda(acc, "ring_quantize"):
        return _su.ring_quantize(acc, scale)
    return ref.ring_quantize_codes(acc, scale)
