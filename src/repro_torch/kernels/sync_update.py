"""The flat-bucket sync kernels — CUDA kernel wrappers (`csrc/sync_update.cu`,
`csrc/ring.cu`), one per Pallas kernel of `repro/kernels/sync_update.py`:

* `sync_flat_update` (its `_kernel`): delta -> optional int8 codes ->
  worker mean -> optional Nesterov -> new anchor, broadcast into every
  worker lane, in one pass.  Updates p, anchor and mu IN PLACE.
* `sync_apply_update` (its `_apply_kernel`): the gather-leg apply of the
  split sync (overlap, partial, ring-int8): dequantize, Nesterov, anchor.
  Writes NEW anchor and mu tensors, so a synced view leaves the state as
  it is.
* `ring_combine` / `ring_quantize` (its `_ring_combine_kernel` /
  `_ring_quantize_kernel`): the int8 ring's per-hop requant pass.  The
  scales stay 0-d device tensors: no hop synchronises with the host.

The two sync passes take a bucket in fp32 or bfloat16 (params and anchor
in the bucket's dtype; scales, mu and step_in fp32): a bf16 bucket runs the
`*_bf16` instance, which computes in fp32 and rounds its stores to nearest
even, bitwise its plain version (`.bf16_launches` counts those).

Each wrapper launches its kernel on CUDA tensors and raises on anything
else; `.launches` counts its launches.  `plain_*` are the plain PyTorch
versions (`kernels/ref.py`), which CPU tensors take through
`kernels/ops.py`; on the card the kernels are bitwise equal to them (the
quantized flat sync, the apply, the combine and the quantize).
"""
from __future__ import annotations

import torch

from repro_torch.errors import ShapeError
from repro_torch.kernels import build
from repro_torch.kernels.ref import ring_combine as plain_ring_combine  # noqa: F401
from repro_torch.kernels.ref import ring_quantize_codes as plain_ring_quantize  # noqa: F401
from repro_torch.kernels.ref import sync_apply_update as plain_apply  # noqa: F401
from repro_torch.kernels.ref import sync_flat_update as plain  # noqa: F401


_BUCKET_DTYPES = (torch.float32, torch.bfloat16)


def _bucket_dtype(name: str, t) -> torch.dtype:
    if t.dtype not in _BUCKET_DTYPES:
        raise ShapeError(f"{name} has dtype {t.dtype}; the sync kernels take "
                         "fp32 or bfloat16 buckets")
    return t.dtype


def sync_flat_update(p, anchor, *, scale=None, mu=None, momentum=0.0):
    """p [W, N] and anchor [N] of one dtype (fp32 or bf16), scale [N] or
    None and mu [N] iff momentum > 0 fp32: contiguous, on one CUDA device.
    Returns (p, anchor, mu | None), updated in place."""
    build.require_cuda("sync_flat_update p", p)
    if p.ndim != 2:
        raise ShapeError(f"sync_flat_update p must be [W, N], got "
                         f"{tuple(p.shape)}")
    w, n = p.shape
    dt = _bucket_dtype("sync_flat_update p", p)
    build.require("sync_flat_update p", p, device=p.device, dtype=dt)
    build.require("sync_flat_update anchor", anchor, device=p.device,
                  dtype=dt, shape=(n,))
    if scale is not None:
        build.require("sync_flat_update scale", scale, device=p.device,
                      dtype=torch.float32, shape=(n,))
    if momentum > 0.0:
        build.require("sync_flat_update mu", mu, device=p.device,
                      dtype=torch.float32, shape=(n,))
    mu_arg = mu if momentum > 0.0 else None
    if n and w:
        lib = build.library()
        fn = (lib.sync_flat_update_bf16 if dt == torch.bfloat16
              else lib.sync_flat_update_f32)
        with torch.cuda.device(p.device):
            err = fn(p.data_ptr(), anchor.data_ptr(),
                     None if scale is None else scale.data_ptr(),
                     None if mu_arg is None else mu_arg.data_ptr(), n, w,
                     float(momentum), build.stream_of(p))
        build.check(err, "sync_flat_update")
        sync_flat_update.launches += 1
        sync_flat_update.bf16_launches += dt == torch.bfloat16
    return p, anchor, mu_arg


sync_flat_update.launches = 0
sync_flat_update.bf16_launches = 0


def _require_vector(name: str, t) -> int:
    build.require_cuda(name, t)
    if t.ndim != 1:
        raise ShapeError(f"{name} must be 1-D, got {tuple(t.shape)}")
    return t.shape[0]


def sync_apply_update(step_in, anchor, *, scale=None, mu=None, momentum=0.0):
    """step_in [N] fp32, anchor [N] fp32 or bf16, scale [N] or None and mu
    [N] iff momentum > 0 fp32: contiguous, on one CUDA device.  Returns NEW
    (anchor in the anchor's dtype, mu | None); the inputs are left as they
    are."""
    n = _require_vector("sync_apply_update step_in", step_in)
    dev = step_in.device
    build.require("sync_apply_update step_in", step_in, device=dev,
                  dtype=torch.float32)
    dt = _bucket_dtype("sync_apply_update anchor", anchor)
    build.require("sync_apply_update anchor", anchor, device=dev,
                  dtype=dt, shape=(n,))
    if scale is not None:
        build.require("sync_apply_update scale", scale, device=dev,
                      dtype=torch.float32, shape=(n,))
    mu_arg = mu if momentum > 0.0 else None
    if momentum > 0.0:
        build.require("sync_apply_update mu", mu, device=dev,
                      dtype=torch.float32, shape=(n,))
    new_a = torch.empty_like(anchor)
    new_mu = torch.empty_like(mu_arg) if mu_arg is not None else None
    if n:
        lib = build.library()
        fn = (lib.sync_apply_update_bf16 if dt == torch.bfloat16
              else lib.sync_apply_update_f32)
        with torch.cuda.device(dev):
            err = fn(step_in.data_ptr(), anchor.data_ptr(),
                     None if scale is None else scale.data_ptr(),
                     None if mu_arg is None else mu_arg.data_ptr(),
                     new_a.data_ptr(),
                     None if new_mu is None else new_mu.data_ptr(), n,
                     float(momentum), build.stream_of(step_in))
        build.check(err, "sync_apply_update")
        sync_apply_update.launches += 1
        sync_apply_update.bf16_launches += dt == torch.bfloat16
    return new_a, new_mu


def _require_scale(name: str, s, device) -> None:
    build.require(name, s, device=device, dtype=torch.float32, shape=())


def ring_combine(q, s, x, k: int):
    """q [n] int8, s () fp32, x [n] fp32, contiguous, on one CUDA device; k
    >= 1 contributors folded so far.  Returns (acc [n] fp32, amax () fp32),
    both new."""
    n = _require_vector("ring_combine q", q)
    dev = q.device
    build.require("ring_combine q", q, device=dev, dtype=torch.int8)
    _require_scale("ring_combine s", s, dev)
    build.require("ring_combine x", x, device=dev, dtype=torch.float32,
                  shape=(n,))
    if int(k) < 1:
        raise ShapeError(f"ring_combine needs k >= 1, got {k}")
    acc = torch.empty(n, dtype=torch.float32, device=dev)
    amax = torch.zeros((), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = build.library().ring_combine_f32(
                q.data_ptr(), s.data_ptr(), x.data_ptr(), acc.data_ptr(),
                amax.data_ptr(), n, int(k), build.stream_of(q))
        build.check(err, "ring_combine")
        ring_combine.launches += 1
    return acc, amax


def ring_quantize(acc, scale):
    """acc [n] fp32, scale () fp32 (guarded > 0), contiguous, on one CUDA
    device.  Returns the int8 codes [n]."""
    n = _require_vector("ring_quantize acc", acc)
    dev = acc.device
    build.require("ring_quantize acc", acc, device=dev, dtype=torch.float32)
    _require_scale("ring_quantize scale", scale, dev)
    q = torch.empty(n, dtype=torch.int8, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = build.library().ring_quantize_f32(
                acc.data_ptr(), scale.data_ptr(), q.data_ptr(), n,
                build.stream_of(acc))
        build.check(err, "ring_quantize")
        ring_quantize.launches += 1
    return q


sync_apply_update.launches = 0
sync_apply_update.bf16_launches = 0
ring_combine.launches = 0
ring_quantize.launches = 0


def reset_bf16_launches() -> None:
    sync_flat_update.bf16_launches = 0
    sync_apply_update.bf16_launches = 0
