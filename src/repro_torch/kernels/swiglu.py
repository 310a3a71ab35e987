"""Fused SwiGLU — CUDA kernel wrapper (`csrc/swiglu.cu`).

Replaces the Pallas `_swiglu_kernel` of `repro/kernels/swiglu.py`: both
products x@wg and x@wi and the silu·mul are computed inside the kernel.
`swiglu` launches it on CUDA tensors and raises on anything else; `plain` is
its plain PyTorch version (`kernels/ref.py`), which CPU tensors take through
`kernels/ops.py`.  `swiglu.launches` counts launches: one per call.

The C entry picks the path from the row count N: up to 8 rows (decode) the
fp32 row kernel, which reads the weights once per tile of 1, 2, 4 or 8
rows; from 9 rows (`kTileMinRows` in the source; prefill) the 3xTF32
tensor-core tiles, which read them once per tile of up to 128 rows.  The
tiles win from 9 rows on, where the row kernel reads the weights twice
(times in PERF.md, `tools/kernel_variants.py`).  Within one path a row's
output does not depend on N.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ShapeError
from repro_torch.kernels import build
from repro_torch.kernels.ref import swiglu as plain  # noqa: F401

_MAX_ROWS = 65535 * 8          # the rows the wrapper takes: 65535 tiles of 8


def swiglu(x: torch.Tensor, wg: torch.Tensor,
           wi: torch.Tensor) -> torch.Tensor:
    """x [..., D]; wg, wi [D, F] -> silu(x@wg) * (x@wi), shape [..., F].
    fp32, contiguous, 16-byte aligned, F % 4 == 0, all on one CUDA device."""
    build.require_cuda("swiglu x", x)
    if wg.ndim != 2:
        raise ShapeError(f"swiglu wg must be [D, F], got {tuple(wg.shape)}")
    d, f = wg.shape
    if x.shape[-1] != d:
        raise ShapeError(f"swiglu x [..., {x.shape[-1]}] vs wg [{d}, {f}]")
    if f % 4:
        raise ShapeError(f"swiglu needs F % 4 == 0 (float4 loads), F={f}")
    build.require("swiglu x", x, device=x.device, dtype=torch.float32,
                  aligned=True)
    for name, w in (("wg", wg), ("wi", wi)):
        build.require(f"swiglu {name}", w, device=x.device,
                      dtype=torch.float32, shape=(d, f), aligned=True)
    n = x.numel() // d if d else 0
    if n > _MAX_ROWS:
        raise ShapeError(f"swiglu takes at most {_MAX_ROWS} rows, got {n}")
    out = torch.empty(x.shape[:-1] + (f,), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        err = build.library().swiglu_f32(
            x.data_ptr(), wg.data_ptr(), wi.data_ptr(), out.data_ptr(), n, d,
            f, build.stream_of(x))
    build.check(err, "swiglu")
    swiglu.launches += 1
    return out


swiglu.launches = 0
