"""Fused SwiGLU forward and backward — CUDA kernel wrappers (`csrc/swiglu.cu`).

Replaces the Pallas `_swiglu_kernel` of `repro/kernels/swiglu.py`: both
products x@wg and x@wi and the silu·mul are computed inside the kernel.
`swiglu` launches it on CUDA tensors and raises on anything else; `plain` is
its plain PyTorch version (`kernels/ref.py`), which CPU tensors take through
`kernels/ops.py`.  `swiglu.launches` counts launches: one per call.

The backward is the port's own (the Pallas kernel has no VJP: the JAX
package differentiates `ref.swiglu`).  `swiglu_bwd` launches the gate
kernel `swiglu_bwd_gate_f32`, which recomputes x@wg and x@wi on the tile
path and writes dg and du, then runs the four products dx = dg wg^T + du
wi^T, dwg = x^T dg and dwi = x^T du as fp32 `torch.matmul` / `addmm` (TF32
off), as the JAX package leaves them to XLA; `swiglu_bwd.launches` counts
its calls (one gate launch and the products each).  `plain_bwd` is its
plain version.  `swiglu_autograd` is the differentiable call (`_SwiGLU`).

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
from repro_torch.kernels.ref import swiglu_bwd as plain_bwd  # noqa: F401
from repro_torch.kernels.ref import swiglu_bwd_products

_MAX_ROWS = 65535 * 8          # the rows the wrapper takes: 65535 tiles of 8


def _check(name, x, wg, wi) -> tuple[int, int, int]:
    """The kernels' operand contract; returns (n, d, f)."""
    build.require_cuda(f"{name} x", x)
    if wg.ndim != 2:
        raise ShapeError(f"{name} wg must be [D, F], got {tuple(wg.shape)}")
    d, f = wg.shape
    if x.shape[-1] != d:
        raise ShapeError(f"{name} x [..., {x.shape[-1]}] vs wg [{d}, {f}]")
    if f % 4:
        raise ShapeError(f"{name} needs F % 4 == 0 (float4 loads), F={f}")
    build.require(f"{name} x", x, device=x.device, dtype=torch.float32,
                  aligned=True)
    for nm, w in (("wg", wg), ("wi", wi)):
        build.require(f"{name} {nm}", w, device=x.device,
                      dtype=torch.float32, shape=(d, f), aligned=True)
    n = x.numel() // d if d else 0
    if n > _MAX_ROWS:
        raise ShapeError(f"{name} takes at most {_MAX_ROWS} rows, got {n}")
    return n, d, f


def swiglu(x: torch.Tensor, wg: torch.Tensor,
           wi: torch.Tensor) -> torch.Tensor:
    """x [..., D]; wg, wi [D, F] -> silu(x@wg) * (x@wi), shape [..., F].
    fp32, contiguous, 16-byte aligned, F % 4 == 0, all on one CUDA device."""
    n, d, f = _check("swiglu", x, wg, wi)
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


def swiglu_bwd(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
               dh: torch.Tensor, need=(True, True, True)):
    """Gradients of `swiglu` for dh [..., F]: (dx [..., D], dwg [D, F], dwi
    [D, F]), None where `need` marks an operand that needs none (its
    products do not run).  `swiglu`'s operand contract; dh fp32, contiguous,
    16-byte aligned.  Allocates dg and du [N, F] (42 MB each at [1024,
    10240])."""
    n, d, f = _check("swiglu_bwd", x, wg, wi)
    build.require("swiglu_bwd dh", dh, device=x.device, dtype=torch.float32,
                  shape=x.shape[:-1] + (f,), aligned=True)
    dg = torch.empty((n, f), dtype=torch.float32, device=x.device)
    du = torch.empty_like(dg)
    if n:
        with torch.cuda.device(x.device):
            err = build.library().swiglu_bwd_gate_f32(
                x.data_ptr(), wg.data_ptr(), wi.data_ptr(), dh.data_ptr(),
                dg.data_ptr(), du.data_ptr(), n, d, f, build.stream_of(x))
        build.check(err, "swiglu_bwd")
    dx, dwg, dwi = swiglu_bwd_products(x.reshape(n, d), wg, wi, dg, du, need)
    swiglu_bwd.launches += 1
    return None if dx is None else dx.reshape(x.shape), dwg, dwi


swiglu.launches = 0
swiglu_bwd.launches = 0


class _SwiGLU(torch.autograd.Function):
    """The forward kernel, and the backward from the saved inputs: g and u
    are recomputed by the gate kernel, not kept."""

    @staticmethod
    def forward(ctx, x, wg, wi):
        ctx.save_for_backward(x, wg, wi)
        return swiglu(x, wg, wi)

    @staticmethod
    def backward(ctx, dh):
        x, wg, wi = ctx.saved_tensors
        return swiglu_bwd(x, wg, wi, dh.contiguous(),
                          need=tuple(ctx.needs_input_grad))


def swiglu_autograd(x: torch.Tensor, wg: torch.Tensor,
                    wi: torch.Tensor) -> torch.Tensor:
    """`swiglu`, differentiable in x, wg and wi."""
    return _SwiGLU.apply(x, wg, wi)
