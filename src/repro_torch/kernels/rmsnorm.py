"""RMSNorm forward — CUDA kernel wrapper (`csrc/rmsnorm.cu`).

Replaces the Pallas `_rmsnorm_kernel` of `repro/kernels/rmsnorm.py`.
`rms_norm` launches the kernel on a CUDA tensor and raises on anything
else; `plain` is its plain PyTorch version (`kernels/ref.py`), which CPU
tensors take through `kernels/ops.py`.  `rms_norm.launches` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rms_norm as plain  # noqa: F401


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] fp32 contiguous on CUDA; scale [D] -> [..., D]."""
    build.require_cuda("rms_norm x", x)
    d = x.shape[-1]
    build.require("rms_norm x", x, device=x.device, dtype=torch.float32)
    build.require("rms_norm scale", scale, device=x.device,
                  dtype=torch.float32, shape=(d,))
    out = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        err = build.library().rmsnorm_f32(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, float(eps),
            build.stream_of(x))
    build.check(err, "rms_norm")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
