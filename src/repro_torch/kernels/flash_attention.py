"""Single-query decode attention — CUDA kernel wrapper (`csrc/flash_decode.cu`).

Replaces the Pallas `_decode_kernel` of `repro/kernels/flash_attention.py`
(`flash_decode`).  `window`, `q_offset` (scalar or per-batch [B]),
`k_positions` (ring-cache absolute positions, -1 = empty) and `prefix_len`
are runtime arguments of the one kernel, so every layer, slot and ring state
shares it.  `flash_decode` launches it on CUDA tensors and raises on
anything else; `plain` is its plain PyTorch version (`ref.attention`), which
CPU tensors take through `kernels/ops.py`.  `flash_decode.launches` counts
launches.

The blocked training kernel `flash_attention` (full-sequence, with a
backward pass) is the next slice's.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ShapeError
from repro_torch.kernels import build
from repro_torch.kernels.ref import attention as plain  # noqa: F401

_MAX_G = 8          # query heads per kv head the kernel holds in registers
_MAX_D = 1024       # head dim: one float4 column per thread of 256


def flash_decode(q, k, v, *, causal=True, window=0, prefix_len=0, q_offset=0,
                 scale=None, k_positions=None):
    """q [B,1,Hq,D] against a KV cache k/v [B,Sk,Hkv,D] -> [B,1,Hq,D].

    q_offset: int or int tensor [B] (absolute query position per batch
    row); k_positions: None (= arange(Sk)) or int tensor [Sk]."""
    build.require_cuda("flash_decode q", q)
    if q.ndim != 4 or k.ndim != 4:
        raise ShapeError(f"flash_decode q/k must be 4-D, got {tuple(q.shape)}"
                         f" / {tuple(k.shape)}")
    b, sq, hq, d = q.shape
    if sq != 1:
        raise ShapeError(f"flash_decode is the single-query kernel, Sq={sq}")
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ShapeError(f"GQA needs Hq % Hkv == 0, got ({hq}, {hkv})")
    if hq // hkv > _MAX_G:
        raise ShapeError(f"flash_decode holds at most {_MAX_G} query heads "
                         f"per kv head, got {hq // hkv}")
    if d % 4 or not 4 <= d <= _MAX_D:
        raise ShapeError(f"flash_decode needs D % 4 == 0 and D <= {_MAX_D}, "
                         f"D={d}")
    if sk < 1:
        raise ShapeError("flash_decode needs at least one key")
    dev = q.device
    build.require("flash_decode q", q, device=dev, dtype=torch.float32,
                  aligned=True)
    for name, t in (("k", k), ("v", v)):
        build.require(f"flash_decode {name}", t, device=dev,
                      dtype=torch.float32, shape=(b, sk, hkv, d), aligned=True)
    qoff = torch.as_tensor(q_offset, device=dev).to(torch.int32).reshape(-1)
    if qoff.numel() == 1:
        qoff = qoff.expand(b)
    qoff = qoff.contiguous()
    build.require("flash_decode q_offset", qoff, device=dev,
                  dtype=torch.int32, shape=(b,))
    kpos = None
    if k_positions is not None:
        kpos = torch.as_tensor(k_positions, device=dev).to(torch.int32)
        kpos = kpos.contiguous()
        build.require("flash_decode k_positions", kpos, device=dev,
                      dtype=torch.int32, shape=(sk,))
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        err = build.library().flash_decode_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            qoff.data_ptr(), None if kpos is None else kpos.data_ptr(),
            b, sk, hq, hkv, d, int(window), int(prefix_len), scale,
            int(bool(causal)), build.stream_of(q))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
