"""Fused SwiGLU forward and backward — CUDA kernel wrappers (`csrc/swiglu.cu`).

Replaces the Pallas `_swiglu_kernel` of `repro/kernels/swiglu.py`: both
products x@wg and x@wi and the silu·mul are computed inside the kernel.
`swiglu` launches it on CUDA tensors and raises on anything else; `plain` is
its plain PyTorch version (`kernels/ref.py`), which CPU tensors take through
`kernels/ops.py`.  `swiglu.launches` counts launches: one per call.

The backward is the port's own (the Pallas kernel has no VJP: the JAX
package differentiates `ref.swiglu`, which keeps g and u from its
forward).  Under autograd `swiglu_fwd` launches the forward with a third
epilogue that writes `out` with the same bits and also the pair p = u
sigma(g) (1 + g (1 - sigma(g))), q = silu(g) (`swiglu_fwd_pair_f32`), and
`swiglu_bwd` writes the gate dg = dh p, du = dh q once into a scratch
and runs the four products from it on the 3xTF32 tensor-core tiles in two
launches (`swiglu_bwd_f32`: dW = x^T [dg | du], then dX = dg wg^T + du
wi^T): nothing is recomputed, and no product goes to cuBLAS.  `swiglu_fwd` counts under
`swiglu.launches`, `swiglu_bwd.launches` one per call.  `plain_fwd` and
`plain_bwd` are their plain versions.  `swiglu_autograd` is the
differentiable call (`_SwiGLU`).

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
from repro_torch.kernels.ref import swiglu_fwd as plain_fwd  # noqa: F401

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


def swiglu_fwd(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor):
    """`swiglu` and the pair its backward reads: (out, p, q), out bitwise
    `swiglu`'s (the same path at every N), p and q [..., F] (`plain_fwd`'s
    semantics).  `swiglu`'s operand contract; one launch."""
    n, d, f = _check("swiglu", x, wg, wi)
    out = torch.empty(x.shape[:-1] + (f,), dtype=x.dtype, device=x.device)
    p, q = torch.empty_like(out), torch.empty_like(out)
    if n == 0:
        return out, p, q
    with torch.cuda.device(x.device):
        err = build.library().swiglu_fwd_pair_f32(
            x.data_ptr(), wg.data_ptr(), wi.data_ptr(), out.data_ptr(),
            p.data_ptr(), q.data_ptr(), n, d, f, build.stream_of(x))
    build.check(err, "swiglu_fwd")
    swiglu.launches += 1
    return out, p, q


def swiglu_bwd(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
               p: torch.Tensor, q: torch.Tensor, dh: torch.Tensor,
               need=(True, True, True)):
    """Gradients of `swiglu` from `swiglu_fwd`'s pair p, q for dh [..., F]:
    (dx [..., D], dwg [D, F], dwi [D, F]), None where `need` marks an
    operand that needs none (its products do not run).  `swiglu`'s operand
    contract; p, q and dh fp32 [..., F], contiguous, 16-byte aligned.
    Allocates the gate's scratch the library asks for (dg and du, [2, N,
    F]: 84 MB at [1024, 10240])."""
    n, d, f = _check("swiglu_bwd", x, wg, wi)
    for nm, t in (("p", p), ("q", q), ("dh", dh)):
        build.require(f"swiglu_bwd {nm}", t, device=x.device,
                      dtype=torch.float32, shape=x.shape[:-1] + (f,),
                      aligned=True)
    dx = torch.empty_like(x) if need[0] else None
    dwg = torch.empty_like(wg) if need[1] else None
    dwi = torch.empty_like(wi) if need[2] else None
    if n == 0:
        return dx, None if dwg is None else dwg.zero_(), \
            None if dwi is None else dwi.zero_()
    lib = build.library()
    scratch = torch.empty(lib.swiglu_bwd_scratch_floats(n, f),
                          dtype=torch.float32, device=x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.swiglu_bwd_f32(
            x.data_ptr(), wg.data_ptr(), wi.data_ptr(), p.data_ptr(),
            q.data_ptr(), dh.data_ptr(), ptr(dx), ptr(dwg), ptr(dwi),
            scratch.data_ptr(), n, d, f, build.stream_of(x))
    build.check(err, "swiglu_bwd")
    swiglu_bwd.launches += 1
    return dx, dwg, dwi


swiglu.launches = 0
swiglu_bwd.launches = 0


class _SwiGLU(torch.autograd.Function):
    """The forward kernel, which also keeps the pair p, q, and the backward
    kernels from the pair."""

    @staticmethod
    def forward(ctx, x, wg, wi):
        out, p, q = swiglu_fwd(x, wg, wi)
        ctx.save_for_backward(x, wg, wi, p, q)
        return out

    @staticmethod
    def backward(ctx, dh):
        x, wg, wi, p, q = ctx.saved_tensors
        return swiglu_bwd(x, wg, wi, p, q, dh.contiguous(),
                          need=tuple(ctx.needs_input_grad))


def swiglu_autograd(x: torch.Tensor, wg: torch.Tensor,
                    wi: torch.Tensor) -> torch.Tensor:
    """`swiglu`, differentiable in x, wg and wi."""
    return _SwiGLU.apply(x, wg, wi)
