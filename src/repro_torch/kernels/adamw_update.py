"""Fused AdamW update — CUDA kernel wrapper (`csrc/adamw_update.cu`).

Replaces the Pallas `_adamw_kernel` of `repro/kernels/adamw_update.py`.
`adamw_update` launches the kernel on CUDA tensors and raises on anything
else; it updates p, m and v IN PLACE (the reference returns new arrays; the
port saves the copies) and returns them.  lr and step are runtime arguments,
so no step rebuilds anything.  `plain` is its plain PyTorch version
(`kernels/ref.py`), which CPU tensors take through `kernels/ops.py`.
`adamw_update.launches` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import adamw_update as plain  # noqa: F401


def adamw_update(p, m, v, g, *, lr, beta1, beta2, eps, weight_decay, step):
    """p, m, v, g: fp32 tensors of one shape (any rank), contiguous and
    16-byte aligned, on one CUDA device; step the 1-based update count (an
    int, float or 0-d tensor).  Returns (p, m, v), updated in place."""
    build.require_cuda("adamw_update p", p)
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        build.require(f"adamw_update {name}", t, device=p.device,
                      dtype=torch.float32, shape=p.shape, aligned=True)
    n = p.numel()
    if n == 0:
        return p, m, v
    with torch.cuda.device(p.device):
        err = build.library().adamw_update_f32(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), n,
            float(lr), float(beta1), float(beta2), float(1.0 - beta1),
            float(1.0 - beta2), float(eps), float(weight_decay), float(step),
            build.stream_of(p))
    build.check(err, "adamw_update")
    adamw_update.launches += 1
    return p, m, v


adamw_update.launches = 0
