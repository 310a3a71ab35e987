"""Attention — CUDA kernel wrappers (`csrc/flash_decode.cu`,
`csrc/flash_attention.cu`).

* `flash_decode` replaces the Pallas `_decode_kernel` of
  `repro/kernels/flash_attention.py`: single-query decode, with `window`,
  `q_offset` (scalar or per-batch [B]), `k_positions` (ring-cache absolute
  positions, -1 = empty) and `prefix_len` as runtime arguments of the one
  kernel, so every layer, slot and ring state shares it.  It splits each
  row's keys over up to 64 blocks and skips the key tiles a row's mask
  wholly excludes.  The plan is computed in C only; `decode_num_splits`,
  `decode_split_plan` and `decode_tiles` are a Python model of it for the
  CPU tests, held against the library's `flash_decode_split_range` and
  `flash_decode_next_tile` by a card test, and the kernel never reads them.
* `flash_attention` replaces the Pallas `_flash_kernel`: full-sequence GQA
  attention, differentiable.  It is a `torch.autograd.Function` whose
  forward launches `flash_attention_fwd` (O and the per-row log-sum-exp)
  and whose backward launches `flash_attention_bwd` (dQ, dK, dV from the
  saved LSE); the JAX package has no backward kernel, so that one is the
  port's own.  causal / window / prefix_len / q_offset are runtime
  arguments.

Each launcher runs its kernel on CUDA tensors and raises on anything else,
and counts its launches (`.launches`, one per call).  `plain` is the plain
PyTorch version (`ref.attention`), which CPU tensors take through
`kernels/ops.py`; on the CPU its gradient is torch's autograd of it.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ShapeError
from repro_torch.kernels import build
from repro_torch.kernels.ref import attention as plain  # noqa: F401

_MAX_G = 16         # query heads per kv head (csrc/flash_decode.cu kMaxG)
_MAX_D = 1024       # head dim: one float4 column per thread of 256
_FA_HEAD_DIMS = (32, 64, 128, 256)  # head dims flash_attention.cu is built for
DECODE_SPLIT_KEYS = 64   # flash_decode's split boundaries: multiples of this
DECODE_UNITS_PER_SPLIT = 2   # a split's share of those 64-key units
DECODE_MAX_SPLITS = 64   # blocks per (batch row, kv head) at most


def decode_num_splits(sk: int) -> int:
    """Blocks `flash_decode` launches per (batch row, kv head), as
    `num_splits` in `csrc/flash_decode.cu`: one per 2 units of 64 keys, at
    most 64.  A function of Sk alone, never of the batch."""
    units = -(-sk // DECODE_SPLIT_KEYS)
    return max(1, min(DECODE_MAX_SPLITS, -(-units // DECODE_UNITS_PER_SPLIT)))


def decode_tile_keys(d: int) -> int:
    """Keys per cp.async tile of `flash_decode` at head dim d."""
    d4 = d // 4
    return 32 if d4 <= 32 else 16 if d4 <= 64 else 8


def decode_allowed(sk: int, qpos: int, *, causal=True, window=0,
                   prefix_len=0, ring=False):
    """(lo, hi, pre, skip): with no ring positions a row at query position
    qpos may attend keys [lo, hi] (none when lo > hi) and [0, pre); `skip`
    is true when it may attend one, and then the kernel walks only the key
    tiles that hold one."""
    lo = max(0, qpos - window + 1) if window > 0 else 0
    hi = min(qpos, sk - 1) if causal else sk - 1
    pre = min(prefix_len, sk) if prefix_len > 0 else 0
    return lo, hi, pre, (not ring and (lo <= hi or pre > 0))


def decode_split_plan(sk: int, qpos: int, *, causal=True, window=0,
                      prefix_len=0, ring=False) -> list[tuple[int, int]]:
    """Key ranges [k0, k1) of one row's splits, as `split_range` in
    `csrc/flash_decode.cu` computes them from q_offset on the card: the
    row's n units of 64 keys (the hull of its allowed keys when it skips,
    else all Sk) spread over min(decode_num_splits(Sk), ceil(n / 2))
    splits, none of them empty.  A function of Sk and the row's own mask
    only."""
    lo, hi, pre, skip = decode_allowed(sk, qpos, causal=causal, window=window,
                                       prefix_len=prefix_len, ring=ring)
    first, last = 0, sk - 1
    if skip:
        if pre > 0:
            last = max(hi, pre - 1) if lo <= hi else pre - 1
        else:
            first, last = lo, hi
    u = DECODE_SPLIT_KEYS
    u0, n = first // u, last // u - first // u + 1
    na = min(decode_num_splits(sk), -(-n // DECODE_UNITS_PER_SPLIT))
    return [((u0 + s * n // na) * u, min((u0 + (s + 1) * n // na) * u, sk))
            for s in range(na)]


def decode_tiles(k0: int, k1: int, tile: int, sk: int, qpos: int, *,
                 causal=True, window=0, prefix_len=0, ring=False) -> list[int]:
    """Starts of the key tiles a split over [k0, k1) walks (`next_tile` in
    `csrc/flash_decode.cu`): every tile, or with `skip` only those holding
    an allowed key."""
    lo, hi, pre, skip = decode_allowed(sk, qpos, causal=causal, window=window,
                                       prefix_len=prefix_len, ring=ring)

    def next_tile(t):
        if not skip or t < pre:
            return t
        if lo > hi or t > hi:
            return k1
        return lo // tile * tile if t + tile - 1 < lo else t

    out, t = [], next_tile(k0)
    while t < k1:
        out.append(t)
        t = next_tile(t + tile)
    return out


def flash_decode(q, k, v, *, causal=True, window=0, prefix_len=0, q_offset=0,
                 scale=None, k_positions=None):
    """q [B,1,Hq,D] against a KV cache k/v [B,Sk,Hkv,D] -> [B,1,Hq,D].

    q_offset: int or int tensor [B] (absolute query position per batch
    row); k_positions: None (= arange(Sk)) or int tensor [Sk].  One call
    counts one launch; on the card it runs one kernel when Sk <= 128 (one
    split per row), else two: the splits, with their partials in a scratch
    allocated here, then the merge."""
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
    lib = build.library()
    floats = lib.flash_decode_scratch_floats(b, hq, sk, d)
    part = None      # the splits' partials (acc, m, l), merged by a 2nd launch
    if floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_decode_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            qoff.data_ptr(), None if kpos is None else kpos.data_ptr(),
            b, sk, hq, hkv, d, int(window), int(prefix_len), scale,
            int(bool(causal)), build.stream_of(q))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _check_full(q, k, v, name):
    """Shape / dtype / layout contract of the full-sequence kernels.
    Returns (b, sq, sk, hq, hkv, d)."""
    build.require_cuda(f"{name} q", q)
    if q.ndim != 4 or k.ndim != 4:
        raise ShapeError(f"{name} q/k must be 4-D, got {tuple(q.shape)} / "
                         f"{tuple(k.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hkv == 0 or hq % hkv != 0:
        raise ShapeError(f"GQA needs Hq % Hkv == 0, got ({hq}, {hkv})")
    if d not in _FA_HEAD_DIMS:
        raise ShapeError(f"{name} is built for head dims {_FA_HEAD_DIMS}, "
                         f"got {d}")
    if sq < 1 or sk < 1:
        raise ShapeError(f"{name} needs Sq, Sk >= 1, got ({sq}, {sk})")
    build.require(f"{name} q", q, device=q.device, dtype=torch.float32,
                  aligned=True)
    for nm, t in (("k", k), ("v", v)):
        build.require(f"{name} {nm}", t, device=q.device, dtype=torch.float32,
                      shape=(b, sk, hkv, d), aligned=True)
    return b, sq, sk, hq, hkv, d


def flash_attention_fwd(q, k, v, *, causal, window, prefix_len, q_offset,
                        scale):
    """q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D] fp32 on CUDA -> (o [B,Sq,Hq,D],
    lse [B,Hq,Sq] fp32)."""
    b, sq, sk, hq, hkv, d = _check_full(q, k, v, "flash_attention_fwd")
    o = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    if b == 0:
        return o, lse
    with torch.cuda.device(q.device):
        err = build.library().flash_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, hq, hkv, d, float(scale),
            int(bool(causal)), int(window), int(prefix_len), int(q_offset),
            build.stream_of(q))
    build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def bwd_scratch_floats(b, hq, sq, sk) -> int:
    """fp32 scratch `flash_attention_bwd_f32` takes as `delta`: its delta rows
    and one chunk of the dS its dK/dV launch stores for its dQ launch, as
    the library sizes it (at most 64 MiB or 64 floats per query row)."""
    return build.library().flash_attention_bwd_scratch_floats(b, sq, sk, hq)


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal, window, prefix_len,
                        q_offset, scale):
    """Gradients of `flash_attention_fwd`'s output: (dq, dk, dv), recomputing
    the probabilities from q, k and the saved lse.  Allocates the scratch
    `bwd_scratch_floats` sizes (59 MB at ViT-B/16's [32,196,12,64])."""
    b, sq, sk, hq, hkv, d = _check_full(q, k, v, "flash_attention_bwd")
    for nm, t in (("o", o), ("dout", dout)):
        build.require(f"flash_attention_bwd {nm}", t, device=q.device,
                      dtype=torch.float32, shape=q.shape, aligned=True)
    build.require("flash_attention_bwd lse", lse, device=q.device,
                  dtype=torch.float32, shape=(b, hq, sq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0:
        return dq, dk, dv
    scratch = torch.empty(bwd_scratch_floats(b, hq, sq, sk),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = build.library().flash_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, sq, sk, hq, hkv, d,
            float(scale), int(bool(causal)), int(window), int(prefix_len),
            int(q_offset), build.stream_of(q))
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len, q_offset, scale):
        mask = dict(causal=causal, window=window, prefix_len=prefix_len,
                    q_offset=q_offset, scale=scale)
        o, lse = flash_attention_fwd(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = mask
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout.contiguous(),
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, prefix_len=0,
                    q_offset=0, scale=None):
    """q [B,Sq,Hq,D]; k, v [B,Sk,Hkv,D] -> [B,Sq,Hq,D], differentiable in q,
    k and v.  fp32, contiguous, 16-byte aligned, D in {32, 64, 128, 256}, on
    one CUDA device; q_offset a Python int (the absolute position of query row
    0).  Semantics: `ref.attention`."""
    build.require_cuda("flash_attention q", q)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 int(prefix_len), int(q_offset), scale)
