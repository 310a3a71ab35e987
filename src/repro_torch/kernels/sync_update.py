"""Fused flat-bucket sync — CUDA kernel wrapper (`csrc/sync_update.cu`).

Replaces the Pallas `_kernel` of `repro/kernels/sync_update.py`
(`sync_flat_update`): delta -> optional int8 codes -> worker mean ->
optional Nesterov -> new anchor, broadcast into every worker lane, in one
pass.  `sync_flat_update` launches the kernel on CUDA tensors and raises on
anything else; it updates p, anchor and mu IN PLACE and returns them.
`plain` is its plain PyTorch version (`kernels/ref.py`), which CPU tensors
take through `kernels/ops.py`; the quantized sync is bitwise equal to it on
the card.  `sync_flat_update.launches` counts launches.

`sync_apply_update`, `ring_combine` and `ring_quantize` (the overlap,
partial and ring-int8 sync paths) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ShapeError
from repro_torch.kernels import build
from repro_torch.kernels.ref import sync_flat_update as plain  # noqa: F401


def sync_flat_update(p, anchor, *, scale=None, mu=None, momentum=0.0):
    """p [W, N], anchor [N], scale [N] or None, mu [N] iff momentum > 0: fp32,
    contiguous, on one CUDA device.  Returns (p, anchor, mu | None), updated
    in place."""
    build.require_cuda("sync_flat_update p", p)
    if p.ndim != 2:
        raise ShapeError(f"sync_flat_update p must be [W, N], got "
                         f"{tuple(p.shape)}")
    w, n = p.shape
    build.require("sync_flat_update p", p, device=p.device,
                  dtype=torch.float32)
    build.require("sync_flat_update anchor", anchor, device=p.device,
                  dtype=torch.float32, shape=(n,))
    if scale is not None:
        build.require("sync_flat_update scale", scale, device=p.device,
                      dtype=torch.float32, shape=(n,))
    if momentum > 0.0:
        build.require("sync_flat_update mu", mu, device=p.device,
                      dtype=torch.float32, shape=(n,))
    mu_arg = mu if momentum > 0.0 else None
    if n and w:
        with torch.cuda.device(p.device):
            err = build.library().sync_flat_update_f32(
                p.data_ptr(), anchor.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if mu_arg is None else mu_arg.data_ptr(), n, w,
                float(momentum), build.stream_of(p))
        build.check(err, "sync_flat_update")
        sync_flat_update.launches += 1
    return p, anchor, mu_arg


sync_flat_update.launches = 0
