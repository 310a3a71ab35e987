"""RMSNorm forward and backward — CUDA kernel wrappers (`csrc/rmsnorm.cu`,
`csrc/rmsnorm_bwd.cu`).

The forward replaces the Pallas `_rmsnorm_kernel` of
`repro/kernels/rmsnorm.py`; the backward is the port's own (the Pallas
kernel has no VJP: the JAX package differentiates `ref.rms_norm`).
`rms_norm` and `rms_norm_bwd` launch their kernels on CUDA tensors and
raise on anything else; `plain` and `plain_bwd` are their plain PyTorch
versions (`kernels/ref.py`), which CPU tensors take through
`kernels/ops.py`.  `rms_norm_autograd` is the differentiable call
(`_RmsNorm`): the forward kernel, then the backward kernel for dx and
dscale.  `.launches` counts calls of each wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.errors import ShapeError
from repro_torch.kernels import build
from repro_torch.kernels.ref import rms_norm as plain  # noqa: F401
from repro_torch.kernels.ref import rms_norm_bwd as plain_bwd  # noqa: F401

# the widest row the backward takes: kWarps = 1 row of floats in the 227 KB
# of shared memory a block can use (`kSmemMax` in csrc/rmsnorm_bwd.cu)
MAX_BWD_D = 232448 // 4


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] fp32 contiguous on CUDA; scale [D] -> [..., D].  One
    launch: rows of up to 3072 floats in registers, wider ones (phi3's
    5120, qwen's 8192) staged in shared memory by cp.async, float4 either
    way where D % 4 == 0 and every operand is 16-byte aligned, else the
    strided path; each path sums in the same order, so the output's bits
    depend on D alone (`csrc/rmsnorm.cu`)."""
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


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `rms_norm` for dy [..., D]: (dx [..., D], dscale [D]).
    fp32, contiguous, on one CUDA device, D <= MAX_BWD_D.  One cooperative
    launch, its grid sized once by `rmsnorm_bwd_grid` for the path the
    operands take (float4 where D % 4 == 0 and every operand is 16-byte
    aligned).  Allocates the [blocks, D] scratch of dscale's partial sums, a
    row for each block of that grid (256 rows, 2.6 MB, at [1024, 2560] on
    an H100); the kernel keeps no state between calls, so calls back to back
    on a stream need no reset."""
    build.require_cuda("rms_norm_bwd x", x)
    d = x.shape[-1]
    build.require("rms_norm_bwd x", x, device=x.device, dtype=torch.float32)
    build.require("rms_norm_bwd scale", scale, device=x.device,
                  dtype=torch.float32, shape=(d,))
    build.require("rms_norm_bwd dy", dy, device=x.device, dtype=torch.float32,
                  shape=x.shape)
    if d > MAX_BWD_D:
        raise ShapeError(f"rms_norm_bwd takes rows of at most {MAX_BWD_D} "
                         f"floats, got {d}")
    dx = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    vec = int(d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (x, scale, dy, dx)))
    lib = build.library()
    blocks = ctypes.c_int()
    with torch.cuda.device(x.device):
        build.check(lib.rmsnorm_bwd_grid(n, d, vec, blocks), "rms_norm_bwd")
        partial = torch.empty(blocks.value * d, dtype=torch.float32,
                              device=x.device)
        err = lib.rmsnorm_bwd_f32(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), partial.data_ptr(), n, d, float(eps), vec,
            blocks.value, build.stream_of(x))
    build.check(err, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx, dscale


rms_norm.launches = 0
rms_norm_bwd.launches = 0


class _RmsNorm(torch.autograd.Function):
    """The forward kernel, and the backward kernel from the saved inputs
    (r is recomputed, bitwise the forward's)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        need_x, need_scale, _ = ctx.needs_input_grad
        return dx if need_x else None, dscale if need_scale else None, None


def rms_norm_autograd(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """`rms_norm`, differentiable in x and scale."""
    return _RmsNorm.apply(x, scale, float(eps))
