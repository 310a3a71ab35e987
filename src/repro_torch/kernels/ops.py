"""Kernel entry points the models call, dispatched by the tensor's device.

The port of `repro/kernels/ops.py`, without its env-var backend switch:

  * a CPU tensor takes the plain PyTorch version (`kernels/ref.py`);
  * a CUDA tensor launches the hand-written CUDA kernel, or raises.

There is no fallback from the kernel to the plain version: a failed build or
launch on the card is an exception.  Models call these; they never touch a
kernel module directly.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import swiglu as _sw

KERNELS = {"rms_norm": _rn.rms_norm, "swiglu": _sw.swiglu,
           "flash_decode": _fa.flash_decode}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ConfigError(f"{op}: no kernel for device {t.device}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    if _on_cuda(x, "rms_norm"):
        return _rn.rms_norm(x, scale, eps)
    return ref.rms_norm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix_len: int = 0, q_offset=0, scale: float | None = None,
                    k_positions=None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D] (GQA by head broadcast).

    On the card, single-query causal decode runs the `flash_decode` kernel;
    the blocked full-sequence kernel is not ported yet, so any other CUDA
    call raises."""
    if not _on_cuda(q, "flash_attention"):
        return ref.attention(q, k, v, causal=causal, window=window,
                             prefix_len=prefix_len, q_offset=q_offset,
                             scale=scale, k_positions=k_positions)
    if q.shape[1] == 1 and causal:
        return _fa.flash_decode(q, k, v, causal=causal, window=window,
                                prefix_len=prefix_len, q_offset=q_offset,
                                scale=scale, k_positions=k_positions)
    raise ConfigError("flash_attention on CUDA: only single-query causal "
                      "decode (flash_decode) is ported yet")


def swiglu(x, wg, wi):
    """Fused silu(x@wg)*(x@wi) — the MLP hot spot."""
    if _on_cuda(x, "swiglu"):
        return _sw.swiglu(x, wg, wi)
    return ref.swiglu(x, wg, wi)
