"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips without a card; on the GPU run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the GPU machine has no jax).
Tolerances: the kernels sum in another order than the plain versions, so
fp32 results agree to ~1e-6 relative; 1e-5 (rms_norm) and 2e-5 (products)
leave an order of magnitude of room, 5e-5 for the attention gradients (two
more contractions).  The backward kernels: rms_norm's dx 1e-5, its dscale
(a sum over the rows) the worst case of two n-term fp32 sums in different
orders (`_dscale_tol`), swiglu's gradients 2e-5 of their largest value.  AdamW runs the plain version's op order with every op
rounded on its own, but its bias correction's pow may differ by an ulp:
1e-6.  The quantized sync, the split sync's apply and the ring's combine
and quantize are held bitwise (integer codes, every op rounded on its own,
no FMA); the unquantized sync bitwise too, against its ops taken lane by
lane in the kernel's order.  Training on the card against the CPU: see
`test_overlap_depth1_on_card_keeps_local_progress_and_matches_cpu`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig
from repro_torch.core import engine as teng
from repro_torch.core import sync as tsync
from repro_torch.data.synthetic import VisionStream, vision_batch_fn
from repro_torch.errors import ShapeError
from repro_torch.kernels import adamw_update as t_ad
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as t_rn
from repro_torch.kernels import swiglu as t_sw
from repro_torch.kernels import sync_update as t_su
from repro_torch.launch import weights as W
from repro_torch.launch.batching import ContinuousBatcher, Request

RMS_TOL = 1e-5
PROD_TOL = 2e-5
GRAD_TOL = 5e-5
ELEM_TOL = 1e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `pytest -m cuda` on the GPU)")
    return torch.device("cuda")


def _t(seed, *shape, scale=1.0, dev="cuda"):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


# swiglu: rows 1-8 take the row kernel, 9 and up the tensor-core tiles (16,
# 32, 64 or 128 rows a tile; 127 / 129 / 4097 sit one off a tile's edge).
# D = 98 leaves a k-tail that is neither a multiple of the 32-wide chunk nor
# of 4, so x's rows are not 16-byte aligned; F = 516 a partial column tile.
@pytest.mark.parametrize("f", [96, 516])
@pytest.mark.parametrize("d", [64, 98, 256])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 16, 127, 129, 300, 4097])
def test_swiglu_and_rms_norm_match_plain(dev, n, d, f):
    x = _t(1, n, d)
    wg, wi = _t(2, d, f, scale=d ** -0.5), _t(3, d, f, scale=d ** -0.5)
    sc = _t(4, d)
    torch.testing.assert_close(t_sw.swiglu(x, wg, wi), tref.swiglu(x, wg, wi),
                               rtol=PROD_TOL, atol=PROD_TOL)
    torch.testing.assert_close(t_rn.rms_norm(x, sc), tref.rms_norm(x, sc),
                               rtol=RMS_TOL, atol=RMS_TOL)


@pytest.mark.parametrize("d,f", [(98, 516), (2560, 1024)])
def test_swiglu_tile_rows_are_bitwise_independent_of_n(dev, d, f):
    """A row's output from the tile path has the same bits whatever the
    call's row count (so whatever its tile) and wherever the row sits in
    it: greedy generate's prefill and a smaller prefill agree bitwise."""
    x = _t(5, 4097, d)
    wg, wi = _t(6, d, f, scale=d ** -0.5), _t(7, d, f, scale=d ** -0.5)
    full = t_sw.swiglu(x, wg, wi)             # 128-row tiles at F = 1024
    torch.testing.assert_close(full, tref.swiglu(x, wg, wi), rtol=PROD_TOL,
                               atol=PROD_TOL)
    big = t_sw.swiglu(x[:300], wg, wi)
    assert torch.equal(big, full[:300])
    for lo, hi in ((0, 9), (0, 16), (200, 225), (68, 100), (36, 84),
                   (100, 229), (254, 300)):
        assert torch.equal(t_sw.swiglu(x[lo:hi], wg, wi), big[lo:hi]), (lo, hi)


# sha256 (first 16 hex digits) of the row kernel's outputs at N <= 8, taken
# on an NVIDIA H100 80GB HBM3 (CUDA 12.8) from `csrc/swiglu.cu` as it was
# before the tile path was added, and equal from the source with it: the
# row kernel is unchanged, so decode keeps these bits
ROW_KERNEL_DIGESTS = {1: "10058d1ca7f4a3c3", 2: "2c314736ff290639",
                      4: "6de4830c458dc090", 5: "1f845f59684d3315",
                      8: "ba1206bd46c907f9"}


# sha256 (first 16 hex digits) of the tile path's outputs (every tile: 16,
# 32, 64 and 128 rows, and D = 98), taken on an NVIDIA H100 80GB HBM3
# (CUDA 12.8) from `csrc/swiglu.cu` as it was before its epilogue became a
# template argument for the backward's gate (`python3 tools/grad_checks.py
# digests DIR`): the forward's tiles keep these bits
TILE_DIGESTS = {(9, 2560, 1024): "ab49e1525e75ef81",
                (32, 2560, 1024): "ee6232a53c265f13",
                (48, 2560, 1024): "13781c2a4fd92636",
                (1024, 2560, 1024): "8a06886ab9a70044",
                (4097, 2560, 1024): "69b5f4027a3feb2c",
                (129, 98, 516): "bd7703d9feaa36ab"}


def tile_digest_cases():
    """{(n, d, f): (x, wg, wi)} on the card, one case per tile."""
    cases = {}
    for n, d, f in ((9, 2560, 1024), (32, 2560, 1024), (48, 2560, 1024),
                    (1024, 2560, 1024), (4097, 2560, 1024), (129, 98, 516)):
        cases[n, d, f] = (_t(41, n, d), _t(42, d, f, scale=d ** -0.5),
                          _t(43, d, f, scale=d ** -0.5))
    return cases


def tile_digest(fn, x, wg, wi) -> str:
    import hashlib
    return hashlib.sha256(fn(x, wg, wi).cpu().numpy().tobytes()).hexdigest()[
        :16]


def test_swiglu_tile_rows_keep_their_bits(dev):
    for key, case in tile_digest_cases().items():
        assert tile_digest(t_sw.swiglu, *case) == TILE_DIGESTS[key], key


@pytest.mark.parametrize("n", [1, 2, 4, 5, 8])
def test_swiglu_decode_rows_keep_the_row_kernels_bits(dev, n):
    import hashlib
    d, f = 2560, 1024
    x = _t(31, n, d)
    wg, wi = _t(32, d, f, scale=d ** -0.5), _t(33, d, f, scale=d ** -0.5)
    got = t_sw.swiglu(x, wg, wi).cpu().numpy()
    assert hashlib.sha256(got.tobytes()).hexdigest()[:16] \
        == ROW_KERNEL_DIGESTS[n]


# (B, Sk, Hkv, g, D, window, prefix_len, q_offset, ring shift | None)
DECODE = [(2, 40, 2, 1, 16, 0, 0, [39, 39], None),
          (3, 50, 1, 4, 64, 0, 0, [3, 49, 17], None),
          (2, 45, 2, 2, 128, 6, 5, [44, 30], None),
          (2, 130, 4, 2, 256, 64, 0, [129, 70], None),
          (2, 24, 2, 2, 96, 10, 0, [60, 45], 40),
          (2, 29, 1, 8, 512, 10, 3, [70, 40], 0),
          (1, 9, 1, 2, 1024, 0, 0, [8], None)]


@pytest.mark.parametrize("case", DECODE)
def test_flash_decode_matches_plain(dev, case):
    b, sk, hkv, g, d, window, prefix, qoff, ring = case
    q, k, v = _t(10, b, 1, hkv * g, d), _t(11, b, sk, hkv, d), \
        _t(12, b, sk, hkv, d)
    kpos = None
    if ring is not None:
        kpos = torch.arange(sk, dtype=torch.int32, device=dev) + ring
        kpos[1::6] = -1
    kw = dict(window=window, prefix_len=prefix, k_positions=kpos,
              q_offset=torch.tensor(qoff, dtype=torch.int32, device=dev))
    torch.testing.assert_close(t_fa.flash_decode(q, k, v, **kw),
                               tref.attention(q, k, v, **kw),
                               rtol=PROD_TOL, atol=PROD_TOL)


# GQA groups of 9-16 query heads per kv head (the G = 16 instance; 12 is
# starcoder2-3b's), through a window, a prefix and a ring cache, at Sk of
# one key, one past two split units and one past the 64-split cap
@pytest.mark.parametrize("sk", [1, 129, 4097])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [9, 12, 16])
def test_flash_decode_wide_groups_match_plain(dev, g, d, sk):
    b, hkv = 3, 2
    q, k, v = _t(60, b, 1, hkv * g, d), _t(61, b, sk, hkv, d), \
        _t(62, b, sk, hkv, d)
    ring = torch.arange(sk, dtype=torch.int32, device=dev) + 200
    ring[2::5] = -1
    for window, prefix, kpos, qoff in (
            (100, 0, None, [sk - 1, sk // 2, 0]),
            (0, 7, None, [sk - 1, sk // 3, -1]),
            (300, 0, ring, [sk + 199, sk // 2 + 200, 150])):
        kw = dict(window=window, prefix_len=prefix, k_positions=kpos,
                  q_offset=torch.tensor(qoff, dtype=torch.int32, device=dev))
        torch.testing.assert_close(t_fa.flash_decode(q, k, v, **kw),
                                   tref.attention(q, k, v, **kw),
                                   rtol=PROD_TOL, atol=PROD_TOL)


# flash_decode at g <= 8 keeps the bits it had before the G = 16 instance
# was added: sha256 (first 16 hex digits) of its outputs on the cases of
# `decode_digest_cases`, taken on an NVIDIA H100 80GB HBM3 (CUDA 12.8) with
# `python3 tools/decode_digests.py DIR` from the sources before that change
# and equal from these (the instances for g <= 8 are not edited)
DECODE_DIGESTS = {
    (1, 64, 40): "f616c702b03c57a6",
    (1, 64, 4097): "b8742c51f209b57d",
    (1, 128, 40): "5cfd7c1852747f29",
    (1, 128, 4097): "b1febe74bfe0fba2",
    (1, 256, 40): "4b3f8c8bcafa11b0",
    (1, 256, 4097): "dd1d641fc0d81464",
    (2, 64, 40): "a0ead27ccb1d1629",
    (2, 64, 4097): "2d68c7b2dff1a65b",
    (2, 128, 40): "76ac57ae49ad95c4",
    (2, 128, 4097): "d6a4a3acc8ae65c1",
    (2, 256, 40): "d905c7bb11280a04",
    (2, 256, 4097): "83fe3113c40e6a7b",
    (4, 64, 40): "0c9aac6dcd3206c6",
    (4, 64, 4097): "fcff50a83e87ce63",
    (4, 128, 40): "4450d6fbe69470a5",
    (4, 128, 4097): "63d515cf2d680c91",
    (4, 256, 40): "192ba7876a89b337",
    (4, 256, 4097): "48ed14c227b7a5f0",
    (8, 64, 40): "922b61631ad28f16",
    (8, 64, 4097): "77276d10a32f98b1",
    (8, 128, 40): "689120bfc871feed",
    (8, 128, 4097): "51778895feac6a91",
    (8, 256, 40): "c2c849b23c78b230",
    (8, 256, 4097): "df4ec6741ef1f868"}


def decode_digest_cases():
    """(g, d, sk) -> the flash_decode arguments whose output is digested."""
    cases = {}
    for g in (1, 2, 4, 8):
        for d in (64, 128, 256):
            for sk, window, prefix in ((40, 0, 0), (4097, 1000, 7)):
                b, hkv = 3, 2
                q, k, v = _t(40 + g, b, 1, hkv * g, d), \
                    _t(41, b, sk, hkv, d), _t(42, b, sk, hkv, d)
                qoff = torch.tensor([sk - 1, sk // 2, sk // 3],
                                    dtype=torch.int32, device="cuda")
                cases[g, d, sk] = (q, k, v, dict(window=window,
                                                 prefix_len=prefix,
                                                 q_offset=qoff))
    return cases


def decode_digest(q, k, v, kw) -> str:
    import hashlib
    out = t_fa.flash_decode(q, k, v, **kw).cpu().numpy()
    return hashlib.sha256(out.tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_flash_decode_narrow_groups_keep_their_bits(dev, g):
    for (cg, d, sk), (q, k, v, kw) in decode_digest_cases().items():
        if cg == g:
            assert decode_digest(q, k, v, kw) == DECODE_DIGESTS[g, d, sk], \
                (d, sk)


def test_flash_decode_no_valid_key_gives_mean_of_v(dev):
    q, k, v = _t(1, 2, 1, 4, 64), _t(2, 2, 37, 2, 64), _t(3, 2, 37, 2, 64)
    kpos = torch.full((37,), -1, dtype=torch.int32, device=dev)
    got = t_fa.flash_decode(q, k, v, k_positions=kpos, q_offset=5)
    torch.testing.assert_close(got, tref.attention(q, k, v, k_positions=kpos,
                                                   q_offset=5),
                               rtol=PROD_TOL, atol=PROD_TOL)
    torch.testing.assert_close(got[:, 0], v.mean(1).repeat_interleave(2, 1),
                               rtol=PROD_TOL, atol=PROD_TOL)


def _allowed_rows(sk, qoff, window, prefix):
    """[B, Sk] bool: the keys each row may attend (no ring positions)."""
    return tref._mask(1, sk, causal=True, window=window, prefix_len=prefix,
                      q_offset=torch.tensor(qoff))[:, 0]


# flash_decode across its split and tile boundaries: Sk in 64-key split
# units, 2 per split.  (g, D, window, prefix_len, ring shift | None); g = 2
# at D <= 256 runs the per-warp loop, g = 8 at D = 256 the block-wide one
SPLIT_SK = [1, 63, 64, 65, 257, 4097]
SPLIT_MASKS = {"causal": (2, 256, 0, 0, None), "window": (2, 256, 100, 0, None),
               "prefix": (2, 64, 40, 70, None), "ring": (2, 128, 300, 0, 500),
               "gqa8-window": (8, 256, 100, 0, None),
               "gqa8-ring": (8, 256, 300, 0, 500)}


def _split_offsets(sk, window, ring):
    """One row at the end of the cache, one in its middle, one whose keys
    are all masked (before the first key, or past the window), one past
    the end of the cache."""
    if ring is not None:
        return [ring + sk - 1, ring + sk // 2, ring - 5, ring + sk + 40]
    dead = -3 if not window else sk + window + 7
    return [sk - 1, sk // 2, dead, sk + 11]


@pytest.mark.parametrize("sk", SPLIT_SK)
@pytest.mark.parametrize("mask", list(SPLIT_MASKS))
def test_flash_decode_across_splits_matches_plain(dev, sk, mask):
    g, d, window, prefix, ring = SPLIT_MASKS[mask]
    b, hkv = 4, 2
    q, k, v = _t(70, b, 1, hkv * g, d), _t(71, b, sk, hkv, d), \
        _t(72, b, sk, hkv, d)
    kpos = None
    if ring is not None:
        kpos = torch.arange(sk, dtype=torch.int32, device=dev) + ring
        kpos[3::7] = -1
    kw = dict(window=window, prefix_len=prefix, k_positions=kpos,
              q_offset=torch.tensor(_split_offsets(sk, window, ring),
                                    dtype=torch.int32, device=dev))
    torch.testing.assert_close(t_fa.flash_decode(q, k, v, **kw),
                               tref.attention(q, k, v, **kw),
                               rtol=PROD_TOL, atol=PROD_TOL)


@pytest.mark.parametrize("g", [2, 8, 12])
@pytest.mark.parametrize("sk", [64, 257, 4097])
def test_flash_decode_row_is_bitwise_independent_of_the_batch(dev, sk, g):
    """Each row of a batch of 8 (live, windowed, prefix and dead rows) gives
    bitwise the output it gives alone: the split plan depends on Sk and the
    row's own mask only (batched decode must equal solo decode)."""
    b, hkv, d = 8, 4, 256
    q, k, v = _t(80, b, 1, hkv * g, d), _t(81, b, sk, hkv, d), \
        _t(82, b, sk, hkv, d)
    qoff = [(i + 1) * sk // 8 - 1 for i in range(b)]
    qoff[2] = -1
    for window, prefix in ((0, 0), (200, 0), (200, 9)):
        kw = dict(window=window, prefix_len=prefix)
        qo = torch.tensor(qoff, dtype=torch.int32, device=dev)
        batched = t_fa.flash_decode(q, k, v, q_offset=qo, **kw)
        for i in range(b):
            alone = t_fa.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      q_offset=qo[i:i + 1], **kw)
            assert torch.equal(batched[i:i + 1], alone), (window, prefix, i)


@pytest.mark.parametrize("g", [2, 8, 12])
@pytest.mark.parametrize("sk", [65, 257, 4097])
@pytest.mark.parametrize("window,prefix", [(0, 0), (100, 0), (64, 30)])
def test_flash_decode_never_reads_masked_tiles(dev, sk, window, prefix, g):
    """K and V rows outside each row's allowed keys hold NaN: the kernel
    skips every tile that holds no allowed key and gives masked keys in the
    tiles it walks zero weight without multiplying their V rows, so the
    output is finite and equals the plain version with those rows zeroed."""
    b, hkv, d = 4, 2, 256
    q, k, v = _t(90, b, 1, hkv * g, d), _t(91, b, sk, hkv, d), \
        _t(92, b, sk, hkv, d)
    qoff = [sk - 1, sk // 2, sk // 3 + 5, min(sk - 1, 140)]
    allowed = _allowed_rows(sk, qoff, window, prefix).to(dev)
    assert bool(allowed.any(-1).all())
    keep = allowed[:, :, None, None]
    kn = torch.where(keep, k, float("nan"))
    vn = torch.where(keep, v, float("nan"))
    kw = dict(window=window, prefix_len=prefix,
              q_offset=torch.tensor(qoff, dtype=torch.int32, device=dev))
    got = t_fa.flash_decode(q, kn, vn, **kw)
    assert bool(torch.isfinite(got).all())
    want = tref.attention(q, torch.where(keep, k, 0.0),
                          torch.where(keep, v, 0.0), **kw)
    torch.testing.assert_close(got, want, rtol=PROD_TOL, atol=PROD_TOL)


def test_flash_decode_split_plan_matches_the_library(dev):
    """The split plan and the tile walk are computed in C only; the Python
    model the CPU tests hold (`decode_split_plan`, `decode_tiles`) gives the
    library's splits, tiles and scratch size on every case."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    k0, k1 = ctypes.c_int(), ctypes.c_int()
    for sk in (1, 63, 64, 65, 128, 129, 1000, 4096, 4097, 8193):
        n = t_fa.decode_num_splits(sk)
        assert lib.flash_decode_scratch_floats(8, 8, sk, 256) == \
            (8 * 8 * n * 258 if n > 1 else 0)
        for qpos in sorted({-1, 0, 5, 63, 64, sk // 2, sk - 1, sk + 300}):
            for kw in (dict(), dict(window=1024), dict(window=100),
                       dict(prefix_len=70), dict(window=64, prefix_len=37),
                       dict(causal=False), dict(ring=True)):
                mask = (int(kw.get("causal", True)), kw.get("window", 0),
                        kw.get("prefix_len", 0), int(kw.get("ring", False)))
                plan = t_fa.decode_split_plan(sk, qpos, **kw)
                got = []
                for s in range(len(plan)):
                    na = lib.flash_decode_split_range(
                        sk, qpos, *mask, s, ctypes.byref(k0),
                        ctypes.byref(k1))
                    assert na == len(plan), (sk, qpos, kw)
                    got.append((k0.value, k1.value))
                assert got == plan, (sk, qpos, kw)
                for tile in (32, 16, 8):
                    for a, b in plan:
                        walk, t = [], lib.flash_decode_next_tile(
                            a, b, tile, sk, qpos, *mask)
                        while t < b:
                            walk.append(t)
                            t = lib.flash_decode_next_tile(
                                t + tile, b, tile, sk, qpos, *mask)
                        assert walk == t_fa.decode_tiles(
                            a, b, tile, sk, qpos, **kw), (sk, qpos, kw, tile)


def test_flash_decode_and_rms_norm_bitwise_repeatable(dev):
    q, k, v = _t(95, 8, 1, 8, 256), _t(96, 8, 4097, 4, 256), \
        _t(97, 8, 4097, 4, 256)
    qo = torch.tensor([(i + 1) * 512 - 1 for i in range(8)],
                      dtype=torch.int32, device=dev)
    for window in (0, 1024):
        a = t_fa.flash_decode(q, k, v, q_offset=qo, window=window)
        assert torch.equal(a, t_fa.flash_decode(q, k, v, q_offset=qo,
                                                window=window))
    x, sc = _t(98, 8192, 2560), _t(99, 2560)
    assert torch.equal(t_rn.rms_norm(x, sc), t_rn.rms_norm(x, sc))


@pytest.mark.parametrize("n", [1, 2, 8, 8192])
@pytest.mark.parametrize("d", [4, 6, 256, 2560, 16384])
def test_rms_norm_matches_plain_and_each_row_alone(dev, n, d):
    """Row in registers (d % 4 == 0, d <= 3072), staged in shared memory
    (16384) or the strided path (d = 6): within tolerance of the plain version, and each row bitwise the
    same as that row normalised alone."""
    x, sc = _t(100, n, d), _t(101, d)
    got = t_rn.rms_norm(x, sc)
    torch.testing.assert_close(got, tref.rms_norm(x, sc), rtol=RMS_TOL,
                               atol=RMS_TOL)
    for i in sorted({0, n // 2, n - 1}):
        assert torch.equal(got[i:i + 1], t_rn.rms_norm(x[i:i + 1], sc))


@pytest.mark.parametrize("d", [256, 2560])
def test_rms_norm_strided_path_gives_the_register_paths_bits(dev, d):
    """A row that is not 16-byte aligned takes the strided path, which sums
    in the register path's order: the same bits."""
    x_mis = _t(102, 3 * d + 1)[1:].view(3, d)        # 4 bytes off
    x_al = x_mis.clone()                              # the same, aligned
    assert x_mis.data_ptr() % 16 and x_al.data_ptr() % 16 == 0
    sc = _t(103, d)
    assert torch.equal(t_rn.rms_norm(x_mis, sc), t_rn.rms_norm(x_al, sc))


def test_wrappers_reject_bad_operands(dev):
    x = _t(1, 4, 64)
    with pytest.raises(ShapeError, match="dtype"):
        t_rn.rms_norm(x.double(), _t(2, 64).double())
    with pytest.raises(ShapeError, match="F % 4"):
        t_sw.swiglu(x, _t(2, 64, 6), _t(3, 64, 6))
    with pytest.raises(ShapeError, match="contiguous"):
        t_sw.swiglu(x, _t(2, 96, 64).T, _t(3, 96, 64).T)
    with pytest.raises(ShapeError, match="single-query"):
        t_fa.flash_decode(_t(1, 1, 2, 2, 16), _t(2, 1, 3, 1, 16),
                          _t(3, 1, 3, 1, 16))
    with pytest.raises(ShapeError, match="query heads"):
        t_fa.flash_decode(_t(1, 1, 1, 17, 16), _t(2, 1, 3, 1, 16),
                          _t(3, 1, 3, 1, 16))


# (B, Sq, Sk, Hkv, g, D, causal, window, prefix_len, q_offset)
FULL = [(2, 196, 196, 3, 1, 64, False, 0, 0, 0),
        (2, 300, 300, 2, 1, 64, True, 0, 0, 0),
        (1, 130, 130, 2, 2, 128, True, 64, 0, 0),
        (2, 77, 77, 1, 4, 128, True, 0, 17, 0),
        (1, 50, 190, 2, 2, 64, True, 0, 0, 140),
        (1, 70, 70, 1, 2, 256, True, 16, 5, 0),
        (1, 9, 9, 2, 1, 64, True, 0, 0, -4),       # rows 0-3: no allowed key
        # the tensor-core tiling's edges: Sq, Sk in {1, 8, 15, 17, 65, 197}
        # (n8 groups cut by the sequence's end, warps wholly past it, single
        # rows), each head dim, GQA g = 8, dead rows across a whole tile
        (2, 1, 1, 2, 1, 64, False, 0, 0, 0),
        (1, 8, 15, 1, 8, 64, True, 0, 0, 7),
        (2, 15, 17, 2, 2, 128, False, 0, 0, 0),
        (1, 17, 8, 2, 1, 256, True, 0, 0, 0),
        (1, 65, 197, 1, 2, 256, True, 0, 0, 132),
        (2, 197, 65, 2, 1, 64, False, 8, 0, 0),
        (1, 197, 197, 1, 8, 128, True, 32, 3, 0),
        (1, 1, 197, 2, 4, 256, True, 0, 0, 196),
        (1, 65, 65, 4, 1, 64, True, 0, 0, -30),    # rows 0-29: no allowed key
        # D = 32 (starcoder2-smoke: 8 heads over 2 kv heads, window 64), and
        # its edges: a tail tile, GQA 8, a prefix, dead rows
        (2, 64, 64, 2, 4, 32, True, 64, 0, 0),
        (1, 197, 197, 2, 1, 32, False, 0, 0, 0),
        (1, 65, 130, 1, 8, 32, True, 16, 5, 65),
        (2, 17, 17, 2, 2, 32, True, 0, 0, -4)]


@pytest.mark.parametrize("case", FULL)
def test_flash_attention_fwd_bwd_match_plain(dev, case):
    b, sq, sk, hkv, g, d, causal, window, prefix, qoff = case
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_offset=qoff)
    q, k, v = _t(20, b, sq, hkv * g, d), _t(21, b, sk, hkv, d), \
        _t(22, b, sk, hkv, d)
    w = _t(23, b, sq, hkv * g, d)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = t_fa.flash_attention(*ins, **kw)
    want = tref.attention(*ref_ins, **kw)
    torch.testing.assert_close(got, want, rtol=PROD_TOL, atol=PROD_TOL)
    g_got = torch.autograd.grad((got * w).sum(), ins)
    g_want = torch.autograd.grad((want * w).sum(), ref_ins)
    for a, b_ in zip(g_got, g_want):
        torch.testing.assert_close(a, b_, rtol=GRAD_TOL, atol=GRAD_TOL)


# (B, Sq, Sk, Hkv, g, D, causal): ViT-B/16's attention, and one causal GQA
REPEAT = [(32, 196, 196, 12, 1, 64, False), (2, 300, 300, 2, 4, 128, True)]


@pytest.mark.parametrize("case", REPEAT)
def test_flash_attention_fwd_bwd_bitwise_repeatable(dev, case):
    """No atomics and a fixed summation order: two runs on the same inputs
    give the same bits (the overlap-vs-blocking training gate rests on it)."""
    b, sq, sk, hkv, g, d, causal = case
    q, k, v = _t(50, b, sq, hkv * g, d), _t(51, b, sk, hkv, d), \
        _t(52, b, sk, hkv, d)
    do = _t(53, b, sq, hkv * g, d)
    kw = dict(causal=causal, window=0, prefix_len=0, q_offset=0,
              scale=d ** -0.5)
    runs = []
    for _ in range(2):
        o, lse = t_fa.flash_attention_fwd(q, k, v, **kw)
        runs.append((o, lse, *t_fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                         **kw)))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_flash_attention_bwd_chunks_ds_past_its_scratch_bound(dev):
    """The backward stores dS for every key while B*Hq*Sq*Sk floats fit 64
    MiB, else in chunks of 64-key multiples.  At Sq = 1100, Sk = 1101 and 8
    query heads one batch row fits (one chunk) and two do not (896 + 205
    keys): the two rows' gradients match the plain version, and each row's
    are bitwise those of the one-chunk run on that row alone."""
    sq, sk, hkv, g, d = 1100, 1101, 4, 2, 128
    kw = dict(causal=True, window=700, prefix_len=0, q_offset=1,
              scale=d ** -0.5)
    mask = {key: kw[key] for key in ("causal", "window", "prefix_len",
                                     "q_offset")}
    rows1, rows2 = sq * hkv * g, 2 * sq * hkv * g
    assert t_fa.bwd_scratch_floats(1, hkv * g, sq, sk) == rows1 + rows1 * 1104
    assert t_fa.bwd_scratch_floats(2, hkv * g, sq, sk) == rows2 + rows2 * 896
    q, k, v = _t(60, 2, sq, hkv * g, d), _t(61, 2, sk, hkv, d), \
        _t(62, 2, sk, hkv, d)
    do = _t(63, 2, sq, hkv * g, d)
    o, lse = t_fa.flash_attention_fwd(q, k, v, **kw)
    grads = t_fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tref.attention(*ins, **mask), ins, do)
    for a, b_ in zip(grads, want):
        torch.testing.assert_close(a, b_, rtol=GRAD_TOL, atol=GRAD_TOL)
    for row in range(2):
        one = [x[row:row + 1].contiguous() for x in (q, k, v, o, lse, do)]
        alone = t_fa.flash_attention_bwd(*one, **kw)
        for a, b_ in zip(grads, alone):
            assert torch.equal(a[row:row + 1], b_)


def test_ops_sends_grad_requiring_single_query_to_the_full_kernel(dev):
    q = _t(1, 2, 1, 4, 64).requires_grad_(True)
    k, v = _t(2, 2, 9, 2, 64), _t(3, 2, 9, 2, 64)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True, q_offset=8)
    out.sum().backward()
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True, q_offset=8)
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    assert ops.launch_counts()["flash_decode"] == 1


@pytest.mark.parametrize("shape,step", [((1000,), 1), ((4, 12, 768, 33), 7),
                                        ((4, 1001), 300)])
def test_adamw_update_matches_plain_in_place(dev, shape, step):
    p, m, g = _t(30, *shape), _t(31, *shape, scale=0.1), _t(32, *shape)
    v = _t(33, *shape, scale=0.01).abs()
    kw = dict(lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.05,
              step=torch.tensor(float(step)))
    want = tref.adamw_update(p, m, v, g, **kw)
    got = t_ad.adamw_update(p, m, v, g, **kw)
    assert got[0] is p and got[1] is m and got[2] is v      # in place
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=ELEM_TOL, atol=ELEM_TOL)


@pytest.mark.parametrize("w,n", [(4, 100_003), (2, 300), (3, 5000)])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_flat_update_matches_plain(dev, w, n, quantize, momentum):
    p, a = _t(40, w, n), _t(41, n)
    scale = _t(42, n).abs() + 0.1 if quantize else None
    mu = _t(43, n) if momentum else None
    want = tref.sync_flat_update(p, a, scale=scale, mu=mu, momentum=momentum)
    got = t_su.sync_flat_update(p.clone(), a.clone(), scale=scale,
                                mu=None if mu is None else mu.clone(),
                                momentum=momentum)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
        elif quantize:      # integer codes, every op rounded alone: bitwise
            assert torch.equal(x, y)
        else:               # the fp32 delta sum runs in another order
            torch.testing.assert_close(x, y, rtol=ELEM_TOL, atol=ELEM_TOL)



# Every instance of the flat sync's kernel: W = 1..8 each its own, 9 and 16
# the one that loads lanes in groups of 8; n % 4 = 0 takes the float4 pass
# and 1..3 the scalar one, as does p at a storage offset of one float; n is
# large enough that the resident grid walks the buffer more than once.
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_flat_update_every_instance_keeps_its_bits(dev, w, r, quantize,
                                                        momentum):
    """Quantized: bitwise the plain version.  Unquantized: bitwise the same
    ops taken lane by lane in the order 0..W-1 (`sync_flat_update_lane_order`,
    each op its own torch kernel).  Two calls on equal inputs: equal bits."""
    n = 1_200_000 + r
    g = torch.Generator(device=dev).manual_seed(w * 10 + r)
    anchor = torch.randn(n, generator=g, device=dev) * 0.02
    p0 = anchor + torch.randn(w, n, generator=g, device=dev) * 1e-3
    scale = ((torch.randn(n, generator=g, device=dev).abs() + 0.1) * 3e-3
             if quantize else None)
    mu = torch.randn(n, generator=g, device=dev) * 1e-4 if momentum else None
    kw = dict(scale=scale, mu=mu, momentum=momentum)
    plain = tref.sync_flat_update if quantize else \
        tref.sync_flat_update_lane_order
    want = plain(p0, anchor, **kw)
    for off in (0, 1):
        runs = []
        for _ in range(2):
            p = torch.empty(w * n + off, device=dev)[off:].view(w, n)
            p.copy_(p0)
            runs.append(t_su.sync_flat_update(
                p, anchor.clone(), scale=scale,
                mu=None if mu is None else mu.clone(), momentum=momentum))
        for got in runs:
            for x, y in zip(got, want):
                assert (x is None and y is None) or torch.equal(x, y)
        for x, y in zip(*runs):
            assert (x is None and y is None) or torch.equal(x, y)


def test_new_wrappers_reject_bad_operands(dev):
    q = _t(1, 1, 8, 2, 96)
    with pytest.raises(ShapeError, match="head dims"):
        t_fa.flash_attention(q, q, q)
    q = _t(1, 1, 8, 2, 64)
    with pytest.raises(ShapeError, match="dtype"):
        t_fa.flash_attention(q.double(), q.double(), q.double())
    x = _t(2, 10)
    with pytest.raises(ShapeError, match="shape"):
        t_ad.adamw_update(x, x, x, _t(3, 11), lr=1e-3, beta1=0.9, beta2=0.99,
                          eps=1e-8, weight_decay=0.0, step=1)
    with pytest.raises(ShapeError, match="\\[W, N\\]"):
        t_su.sync_flat_update(x, x)


def test_batcher_on_card_launches_kernels_and_matches_cpu(dev):
    """Every decode step runs 2L+1 rms_norm, L swiglu and L flash_decode
    launches, and greedy tokens equal the CPU server's on the same
    weights."""
    cfg = TR.get_smoke_config("gemma3-4b")
    card = W.ServingWeights.from_seed(cfg, 0, device=dev)
    host = W.ServingWeights(cfg, card.spec.unflatten(
        {b: t.cpu() for b, t in card.bufs.items()}), device="cpu")
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab, n)
               for i, n in enumerate((5, 9, 7))]

    def serve(weights):
        b = ContinuousBatcher(cfg, weights, slots=2, max_len=48)
        reqs = [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run()
        return b, [r.out for r in reqs]

    ops.reset_launch_counts()
    b, on_card = serve(card)
    L, steps = cfg.n_layers, b.decode_steps
    assert ops.launch_counts() == {"rms_norm": (2 * L + 1) * steps,
                                   "swiglu": L * steps,
                                   "rms_norm_bwd": 0, "swiglu_bwd": 0,
                                   "flash_decode": L * steps,
                                   "flash_attention_fwd": 0,
                                   "flash_attention_bwd": 0,
                                   "adamw_update": 0, "sync_flat_update": 0,
                                   "sync_apply_update": 0, "ring_combine": 0,
                                   "ring_quantize": 0}
    assert on_card == serve(host)[1]


@pytest.mark.parametrize("n", [1000, 100_003])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_apply_update_matches_plain_bitwise(dev, n, quantize, momentum):
    """Bitwise, out of place, on aligned buffers and on a view at an odd
    offset (the kernel's scalar pass)."""
    for off in (0, 1):
        step = _t(50, n + off)[off:]
        if quantize:
            step = torch.round(step * 100) / 4
        anchor = _t(51, n + off)[off:]
        scale = (_t(52, n).abs() + 0.1) * 1e-2 if quantize else None
        mu = _t(53, n, scale=1e-3) if momentum else None
        kw = dict(scale=scale, mu=mu, momentum=momentum)
        keep = [x.clone() for x in (step, anchor) + ((mu,) if momentum
                                                      else ())]
        want = tref.sync_apply_update(step, anchor, **kw)
        got = t_su.sync_apply_update(step, anchor, **kw)
        for x, y in zip(got, want):
            assert (x is None and y is None) or torch.equal(x, y)
        assert got[0].data_ptr() != anchor.data_ptr()
        for a, b in zip(keep, (step, anchor) + ((mu,) if momentum else ())):
            assert torch.equal(a, b)               # inputs left as they are


@pytest.mark.parametrize("n", [1, 7, 4096, 100_003])
def test_ring_kernels_match_plain_bitwise(dev, n):
    x_all = _t(60, 2 * n + 1, scale=1e-3)
    acc = _t(61, n, scale=1e-3)
    s = acc.abs().max()
    q = t_su.ring_quantize(acc, s)
    assert torch.equal(q, tref.ring_quantize_codes(acc, s))
    for k in (1, 2, 3):
        for x in (x_all[:n], x_all[n + 1:]):      # aligned, then offset
            got = t_su.ring_combine(q, s, x, k)
            want = tref.ring_combine(q, s, x, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            assert got[1].shape == () and got[1].device == q.device
        q2 = t_su.ring_quantize(got[0], got[1])
        assert torch.equal(q2, tref.ring_quantize_codes(got[0], got[1]))


def test_ring_codes_on_card_equal_cpu_and_count_launches(dev):
    d = _t(70, 4, 10_003, scale=1e-3)
    ops.reset_launch_counts()
    q, s = tsync.ring_codes_host(d)
    counts = ops.launch_counts()
    assert counts["ring_quantize"] == 16 and counts["ring_combine"] == 12
    qc, sc = tsync.ring_codes_host(d.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)


def test_new_sync_wrappers_reject_bad_operands(dev):
    x = _t(1, 10)
    with pytest.raises(ShapeError, match="1-D"):
        t_su.sync_apply_update(_t(1, 2, 5), x)
    with pytest.raises(ShapeError, match="mu"):
        t_su.sync_apply_update(x, x, momentum=0.9)
    with pytest.raises(ShapeError, match="dtype"):
        t_su.ring_combine(x, x.abs().max(), x, 1)
    with pytest.raises(ShapeError, match="shape"):
        t_su.ring_quantize(x, x[:1])
    with pytest.raises(ShapeError, match="k >= 1"):
        t_su.ring_combine(x.to(torch.int8), x.abs().max(), x, 0)


def _tiny_engine(device, depth=1, **run_kw):
    # two heads of 64: the card's attention kernel takes head dims 64+
    cfg = dataclasses.replace(TR.get_smoke_config("vit-b16"), n_classes=16,
                              n_heads=2, n_kv_heads=2)
    run = RunConfig(schedule="constant", h_base=2, total_steps=6,
                    peak_lr=6e-3, end_lr=1e-5, weight_decay=0.01,
                    remat=False, sync_quantize=True, outer_momentum=0.9,
                    **run_kw)
    fn = vision_batch_fn(VisionStream(n_classes=16, seed=42), 2, 2)
    return teng.RoundEngine(cfg, run, workers=2, b_loc=2, seq=1, data="host",
                            layout="flat", sync="overlap",
                            overlap_depth=depth, batch_fn=fn, device=device)


def test_synced_view_on_card_is_pure(dev):
    eng = _tiny_engine(dev)
    st = eng.init_state()
    st, _ = eng.run_round(st, 0, 2, lambda t: 6e-3)
    st, _ = eng.run_round(st, 2, 2, lambda t: 6e-3)
    before = [x.clone() for x in T.leaves(st)]
    v1, v2 = eng.synced_view(st), eng.synced_view(st)
    for a, b in zip(T.leaves(st), before):
        assert torch.equal(a, b)            # anchor, mu, params untouched
    fl = eng.flush(st)
    for a, b, c in zip(T.leaves(v1), T.leaves(v2), T.leaves(fl)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_overlap_keeps_the_stale_steps_progress_on_card(dev):
    """At depth = h the pending sync applies after the round's last step as
    x_i + (consensus - entry_i), which keeps each lane's own progress; had
    `entry` aliased the params that the card's in-place AdamW advances,
    every lane would collapse onto the consensus."""
    eng = _tiny_engine(dev, depth=2)
    st = eng.init_state()
    for t in (0, 2):
        st, _ = eng.run_round(st, t, 2, lambda s: 6e-3)
    p = st["params"]["float32"]
    # two AdamW steps move most elements by ~lr; a collapse leaves rounding
    assert float((p[0] - p[1]).abs().max()) > 1e-3
    c = eng.synced_view({**st, "params": {"float32": p.clone()}})
    assert torch.equal(c["params"]["float32"][0], c["params"]["float32"][1])


def test_overlap_depth1_on_card_keeps_local_progress_and_matches_cpu(dev):
    """The correction form x_i + (consensus - entry_i) on the card against
    the CPU after 3 rounds: a missing clone of `entry` would lose each
    lane's stale step on the card only (then ~all elements differ, by up
    to lr: relative L2 ~8e-2).  The int8 sync turns AdamW's sum-order noise
    into whole code levels (amax / 127 of a leaf's delta) wherever a delta
    sits near a rounding boundary, so chip_smoke's unquantized card-vs-CPU
    rule (1 in 2,000 elements beyond 1e-5) does not hold here: measured on
    an H100 (700 W), 0.32% of the elements beyond 1e-5, max 2.2e-4,
    relative L2 6.6e-5 (0.77% for the blocking quantized sync, 4 in
    727,840 unquantized).  Held: at most 1 in 100 beyond 1e-5, relative L2
    within 1e-3, none beyond 4 lr."""
    engines = {"cuda": _tiny_engine(dev), "cpu": _tiny_engine("cpu")}
    card = engines["cuda"].init_state()
    states = {"cuda": card,
              "cpu": T.map(lambda x: x.to("cpu", copy=True), card)}
    counts = {}
    for dv, eng in engines.items():
        ops.reset_launch_counts()
        for t in (0, 2, 4):
            states[dv], _ = eng.run_round(states[dv], t, 2, lambda s: 6e-3)
        counts[dv] = ops.launch_counts()
    assert counts["cuda"]["sync_apply_update"] == 2      # rounds 2 and 3
    assert counts["cuda"]["sync_flat_update"] == 0
    p = states["cuda"]["params"]["float32"]
    assert not torch.equal(p[0], p[1])
    a, b = p.cpu(), states["cpu"]["params"]["float32"]
    d = (a - b).abs()
    off = int((d > 1e-5 * (1 + b.abs())).sum())
    assert off <= b.numel() // 100, off
    assert float(d.norm()) <= 1e-3 * float(b.norm())
    assert float(d.max()) <= 4 * 6e-3


def _dscale_tol(x, dy, eps=1e-6):
    """The bound dscale is held to: 2 n 2^-24 of the largest column sum of
    |dy x r| over the n rows, the worst case of two n-term fp32 sums in
    different orders (the kernel's block partials against torch's sum)."""
    d = x.shape[-1]
    x2, g2 = x.reshape(-1, d).double(), dy.reshape(-1, d).double()
    r = torch.rsqrt(torch.mean(x2 * x2, -1, keepdim=True) + eps)
    return max(2 * x2.shape[0] * 2.0 ** -24
               * float((g2 * x2 * r).abs().sum(0).max()), RMS_TOL)


def _grads_of(fn, ins, dout):
    xs = [t.detach().clone().requires_grad_(True) for t in ins]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, dout)


@pytest.mark.parametrize("d", [256, 2560, 2562, 3072, 5120, 8192])
@pytest.mark.parametrize("n", [1, 8, 9, 48, 1024])
def test_rms_norm_and_swiglu_under_autograd_match_plain(dev, n, d):
    """`ops.rms_norm` / `ops.swiglu` under autograd on the card (the
    `_RmsNorm` / `_SwiGLU` Functions: the forward kernel, then
    `rms_norm_bwd` / `swiglu_bwd`) against autograd of the plain versions:
    one launch of each; d = 2562 takes rms_norm's strided path and
    swiglu's unaligned x rows, 5120 (phi3's width) and 8192 (qwen's) the
    staged paths of both rms_norm kernels."""
    x, sc, dy = _t(1, n, d), _t(2, d), _t(3, n, d)
    f = 256
    wg, wi = _t(4, d, f, scale=d ** -0.5), _t(5, d, f, scale=d ** -0.5)
    dh = _t(6, n, f)
    ops.reset_launch_counts()
    out, got = _grads_of(ops.rms_norm, (x, sc), dy)
    sout, sgot = _grads_of(ops.swiglu, (x, wg, wi), dh)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == dict(
        rms_norm=1, rms_norm_bwd=1, swiglu=1, swiglu_bwd=1)
    wout, want = _grads_of(tref.rms_norm, (x, sc), dy)
    swout, swant = _grads_of(tref.swiglu, (x, wg, wi), dh)
    torch.testing.assert_close(out, wout, rtol=RMS_TOL, atol=RMS_TOL)
    torch.testing.assert_close(got[0], want[0], rtol=RMS_TOL,
                               atol=RMS_TOL * max(1.0, float(
                                   want[0].abs().max())))
    torch.testing.assert_close(got[1], want[1], rtol=0.0,
                               atol=_dscale_tol(x, dy))
    torch.testing.assert_close(sout, swout, rtol=PROD_TOL, atol=PROD_TOL)
    for a, b in zip(sgot, swant):
        torch.testing.assert_close(a, b, rtol=PROD_TOL, atol=PROD_TOL * max(
            1.0, float(b.abs().max())))


@pytest.mark.parametrize("n,d", [(1, 2560), (9, 256), (1024, 2560),
                                 (1024, 5120), (7, 2562)])
def test_backward_kernels_are_bitwise_repeatable(dev, n, d):
    """No float atomics, a grid fixed by the shape: a second call on the
    same inputs gives the same bits (the overlap and resume gates rest on
    it)."""
    x, sc, dy = _t(7, n, d), _t(8, d), _t(9, n, d)
    a, b = t_rn.rms_norm_bwd(x, sc, dy), t_rn.rms_norm_bwd(x, sc, dy)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    wg, wi, dh = _t(10, d, 512, scale=0.02), _t(11, d, 512, scale=0.02), \
        _t(12, n, 512)
    _, pg, pu = t_sw.swiglu_fwd(x, wg, wi)
    a = t_sw.swiglu_bwd(x, wg, wi, pg, pu, dh)
    b = t_sw.swiglu_bwd(x, wg, wi, pg, pu, dh)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# rms_norm_bwd's paths: registers (d % 4 == 0, d <= 3072), rows staged in
# shared memory (3076 is the first width past the registers: phi3's 5120,
# qwen's 8192), scalar (2562); rows from one to past the resident grid's
# rows a pass (4099: 1056 rows a pass at d = 2560 on an H100, 396 at 5120),
# so the row rule and the reduce's column stripes meet their edges
RMS_BWD_D = [256, 2560, 2562, 3072, 3076, 5120, 8192]
RMS_BWD_N = [1, 7, 1024, 4099]


@pytest.mark.parametrize("d", RMS_BWD_D)
@pytest.mark.parametrize("n", RMS_BWD_N)
def test_rms_norm_bwd_matches_plain_on_every_path(dev, n, d):
    """dx within 1e-5 of the plain backward, dscale within `_dscale_tol`,
    and a second call bitwise (one cooperative launch: no float atomics, a
    grid fixed by n, d and the card)."""
    x, sc, dy = _t(21, n, d), _t(22, d), _t(23, n, d)
    dx, ds = t_rn.rms_norm_bwd(x, sc, dy)
    dx2, ds2 = t_rn.rms_norm_bwd(x, sc, dy)
    wdx, wds = tref.rms_norm_bwd(x, sc, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    torch.testing.assert_close(dx, wdx, rtol=RMS_TOL, atol=RMS_TOL * max(
        1.0, float(wdx.abs().max())))
    torch.testing.assert_close(ds, wds, rtol=0.0, atol=_dscale_tol(x, dy))


# the forward's staged rows (aligned, 3072 < d: phi3's 5120, qwen's 8192)
RMS_STAGED_D = [3076, 5120, 8192]


def _one_float_off(t):
    """A copy of `t` 4 bytes past 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("d", RMS_STAGED_D)
@pytest.mark.parametrize("n", RMS_BWD_N)
def test_rms_norm_staged_rows_keep_the_strided_paths_bits(dev, n, d):
    """Aligned rows past the registers are staged in shared memory; the
    same rows one float off alignment take the strided path, which every
    such row took before the staged one: bitwise the same output, and
    within tolerance of the plain version."""
    x, sc = _t(30, n, d), _t(31, d)
    got = t_rn.rms_norm(x, sc)
    torch.testing.assert_close(got, tref.rms_norm(x, sc), rtol=RMS_TOL,
                               atol=RMS_TOL)
    assert torch.equal(got, t_rn.rms_norm(_one_float_off(x),
                                          _one_float_off(sc)))


@pytest.mark.parametrize("d", RMS_STAGED_D)
def test_rms_norm_staged_rows_are_bitwise_repeatable(dev, d):
    x, sc = _t(32, 1031, d), _t(33, d)
    assert torch.equal(t_rn.rms_norm(x, sc), t_rn.rms_norm(x, sc))


@pytest.mark.parametrize("d", [2560, 5120])
def test_rms_norm_bwd_scalar_path_gives_the_float4_paths_dx_bits(dev, d):
    """Operands one float off 16-byte alignment take the scalar path; its
    dx sums and expressions are the register and staged paths', so dx keeps
    its bits (dscale is held to its tolerance: another grid)."""
    n = 33
    x, sc, dy = _t(24, n, d), _t(25, d), _t(26, n, d)
    dx, ds = t_rn.rms_norm_bwd(x, sc, dy)
    bufs = [torch.empty(t.numel() + 1, device=t.device) for t in (x, sc, dy)]
    xs, ss, gs = (b[1:].view(t.shape).copy_(t)
                  for b, t in zip(bufs, (x, sc, dy)))
    assert xs.data_ptr() % 16
    sdx, sds = t_rn.rms_norm_bwd(xs, ss, gs)
    assert torch.equal(sdx, dx)
    torch.testing.assert_close(sds, ds, rtol=0.0, atol=2 * _dscale_tol(x, dy))


def test_rms_norm_bwd_takes_its_widest_row(dev):
    """MAX_BWD_D floats (past the staged rows: the scalar path, one warp a
    block) run; one more raises
    (`test_backward_wrappers_reject_bad_operands`)."""
    d = t_rn.MAX_BWD_D
    x, sc, dy = _t(27, 3, d), _t(28, d), _t(29, 3, d)
    dx, ds = t_rn.rms_norm_bwd(x, sc, dy)
    wdx, wds = tref.rms_norm_bwd(x, sc, dy)
    torch.testing.assert_close(dx, wdx, rtol=RMS_TOL, atol=RMS_TOL * max(
        1.0, float(wdx.abs().max())))
    torch.testing.assert_close(ds, wds, rtol=0.0, atol=_dscale_tol(x, dy))


def test_swiglu_fwd_keeps_the_forward_bits_and_the_pair(dev):
    """The forward under autograd (`swiglu_fwd`) writes out with the
    forward kernel's bits on both paths (`ROW_KERNEL_DIGESTS` at N <= 8,
    `TILE_DIGESTS` from 9 rows) and the pair p, q within the products'
    tolerance of the plain version's."""
    d, f = 2560, 1024
    for n in ROW_KERNEL_DIGESTS:
        x = _t(31, n, d)
        wg, wi = _t(32, d, f, scale=d ** -0.5), _t(33, d, f, scale=d ** -0.5)
        assert tile_digest(lambda *a: t_sw.swiglu_fwd(*a)[0], x, wg, wi) \
            == ROW_KERNEL_DIGESTS[n], n
    for key, case in tile_digest_cases().items():
        assert tile_digest(lambda *a: t_sw.swiglu_fwd(*a)[0], *case) \
            == TILE_DIGESTS[key], key
        got, want = t_sw.swiglu_fwd(*case), tref.swiglu_fwd(*case)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=PROD_TOL, atol=PROD_TOL)


# (n, d, f): the row kernel's rows; D = 98 (x's rows unaligned, partial
# tiles everywhere); dW's 128 x 128 tiles (d 2560, f 2048); dX's 64 x 128,
# 128 x 128 (2048 x 2048) and 128 x 160 (1024 x 2560) tiles
SWIGLU_BWD_SHAPES = [(1, 64, 96), (9, 98, 516), (129, 256, 132),
                     (300, 2560, 2048), (2048, 2048, 64), (1024, 2560, 64)]
NEEDS = [(True, True, True), (True, False, False), (False, True, False),
         (False, False, True), (False, True, True), (True, True, False),
         (True, False, True)]


@pytest.mark.parametrize("n,d,f,need", [
    *[(*shape, NEEDS[0]) for shape in SWIGLU_BWD_SHAPES],
    *[(9, 98, 516, need) for need in NEEDS[1:]]])
def test_swiglu_bwd_matches_plain_from_the_pair(dev, n, d, f, need):
    """swiglu_bwd (the gate's launch, then the dW and dX tiles) against the
    plain backward on the same pair: each gradient within PROD_TOL of its
    largest value, None where `need` says so."""
    x, dh = _t(21, n, d), _t(22, n, f)
    wg, wi = _t(23, d, f, scale=d ** -0.5), _t(24, d, f, scale=d ** -0.5)
    _, p, q = t_sw.swiglu_fwd(x, wg, wi)
    got = t_sw.swiglu_bwd(x, wg, wi, p, q, dh, need=need)
    want = tref.swiglu_bwd(x, wg, wi, p, q, dh, need=need)
    for a, b, nd in zip(got, want, need):
        assert (a is None) == (b is None) == (not nd)
        if nd:
            torch.testing.assert_close(a, b, rtol=PROD_TOL, atol=PROD_TOL * max(
                1.0, float(b.abs().max())))


def test_swiglu_bwd_runs_no_library_product(dev):
    """The card's swiglu_bwd runs its four products in the port's own
    kernels: no aten matrix product is dispatched during the call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))
    x, dh = _t(21, 256, 512), _t(22, 256, 1024)
    wg, wi = _t(23, 512, 1024, scale=0.04), _t(24, 512, 1024, scale=0.04)
    _, p, q = t_sw.swiglu_fwd(x, wg, wi)
    with Ops() as ops_seen:
        t_sw.swiglu_bwd(x, wg, wi, p, q, dh)
    assert ops_seen.names and not [
        n for n in ops_seen.names
        if any(k in n for k in ("mm", "matmul", "linear", "baddbmm"))], \
        ops_seen.names


@pytest.mark.parametrize("n", [2, 9, 1024])
def test_serving_forward_keeps_its_bits_beside_autograd(dev, n):
    """Without a gradient ops launches the forward kernels alone (no
    backward launch), and the Functions' forward output is bitwise the
    same kernel's."""
    x, sc = _t(13, n, 2560), _t(14, 2560)
    wg, wi = _t(15, 2560, 1024, scale=0.02), _t(16, 2560, 1024, scale=0.02)
    want_n, want_s = t_rn.rms_norm(x, sc), t_sw.swiglu(x, wg, wi)
    xg = x.clone().requires_grad_(True)
    ops.reset_launch_counts()
    with torch.no_grad():
        assert torch.equal(ops.rms_norm(xg, sc), want_n)
        assert torch.equal(ops.swiglu(xg, wg, wi), want_s)
    assert torch.equal(ops.rms_norm(x, sc), want_n)
    assert torch.equal(ops.swiglu(x, wg, wi), want_s)
    assert torch.equal(ops.rms_norm(xg, sc).detach(), want_n)
    assert torch.equal(ops.swiglu(xg, wg, wi).detach(), want_s)
    assert {k: v for k, v in ops.launch_counts().items() if v} == dict(
        rms_norm=3, swiglu=3)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_repeats_only_the_forward_launches(dev, remat):
    """gemma3-smoke's loss and gradients on the card: with remat each
    layer's forward runs again in the backward (torch.utils.checkpoint), so
    the forward kernels launch twice per layer and the backward kernels
    once; the gradients agree with remat's within 1e-5 (the tied
    embedding's gradient is accumulated by index_put_, whose order on the
    card is not fixed)."""
    from repro_torch.models import api, param as pm
    from repro_torch.models import transformer as ttf
    cfg = TR.get_smoke_config("gemma3-4b")
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = pm.init_params(api.get_module(cfg).param_defs(cfg), gen,
                            device="cuda")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))
                                 .astype(np.int32)).cuda()
             for k in ("tokens", "labels")}
    out = {}
    for r in (False, remat):
        leaves, treedef = T.flatten(params)
        alias = [x.detach().requires_grad_(True) for x in leaves]
        ops.reset_launch_counts()
        loss = ttf.loss_fn(cfg, T.unflatten(treedef, alias), batch, remat=r)
        grads = torch.autograd.grad(loss, alias)
        torch.cuda.synchronize()
        out[r] = (grads, {k: v for k, v in ops.launch_counts().items() if v})
    n, fwd = cfg.n_layers, 2 if remat else 1
    assert out[remat][1] == dict(
        rms_norm=2 * n * fwd + 1, rms_norm_bwd=2 * n + 1, swiglu=n * fwd,
        swiglu_bwd=n, flash_attention_fwd=n * fwd, flash_attention_bwd=n)
    for a, b in zip(out[False][0], out[remat][0]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5 * max(
            1.0, float(a.abs().max())))


def test_backward_wrappers_reject_bad_operands(dev):
    x = _t(1, 4, 64)
    with pytest.raises(ShapeError, match="shape"):
        t_rn.rms_norm_bwd(x, _t(2, 64), _t(3, 4, 63))
    with pytest.raises(ShapeError, match="at most"):
        big = t_rn.MAX_BWD_D + 1
        t_rn.rms_norm_bwd(_t(1, 1, big), _t(2, big), _t(3, 1, big))
    pair = (_t(5, 4, 96), _t(6, 4, 96))
    with pytest.raises(ShapeError, match="dh"):
        t_sw.swiglu_bwd(x, _t(2, 64, 96), _t(3, 64, 96), *pair, _t(4, 4, 92))
    with pytest.raises(ShapeError, match="dtype"):
        t_sw.swiglu_bwd(x, _t(2, 64, 96), _t(3, 64, 96), *pair,
                        _t(4, 4, 96).double())
    with pytest.raises(ShapeError, match="p has shape"):
        t_sw.swiglu_bwd(x, _t(2, 64, 96), _t(3, 64, 96), _t(5, 4, 92),
                        pair[1], _t(4, 4, 96))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-4b"])
def test_lm_local_step_on_card_matches_cpu(dev, arch):
    """One Local AdamW step of starcoder2-smoke (layernorm + GELU) or
    gemma3-smoke (rms_norm + SwiGLU through their backward kernels) at W =
    2 from the same weights and token batch on the card and on the CPU: the
    loss and the grad norm within 1e-5 relative, the params under the
    1-in-2,000 rule of `tests/test_torch_train.py` (AdamW's first step flips
    where a gradient sits at the sum-order noise), and one attention
    forward and backward launch per layer per worker (gemma3: one rms_norm
    and rms_norm_bwd per norm, one swiglu and swiglu_bwd per layer)."""
    from repro_torch.core import local_update as LU
    from repro_torch.data.synthetic import TokenStream, make_train_batch
    from repro_torch.models import api, param as pm
    cfg = TR.get_smoke_config(arch)
    run = RunConfig(peak_lr=3e-3, remat=False)
    gen = torch.Generator().manual_seed(5)
    host = pm.init_params(api.get_module(cfg).param_defs(cfg), gen)
    batch = make_train_batch(cfg, TokenStream(vocab=cfg.vocab), 0, 2, 2, 16)
    step = LU.make_local_step(cfg, run, with_metrics=True)
    out = {}
    for d in ("cuda", "cpu"):
        st = LU.init_state(cfg, run, T.map(lambda x: x.to(d), host), 2)
        ops.reset_launch_counts()
        st, (loss, gn) = step(st, T.map(lambda x: x.to(d), batch), 3e-3)
        out[d] = (st, float(loss), float(gn), ops.launch_counts())
    (sc, lc, gc, counts), (sh, lh, gh, _) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh) and abs(gc - gh) <= 1e-5 * abs(gh)
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] \
        == 2 * cfg.n_layers
    assert counts["adamw_update"] == len(T.leaves(sh["params"]))
    gemma = arch == "gemma3-4b"
    norms, mlps = 2 * (2 * cfg.n_layers + 1), 2 * cfg.n_layers
    assert counts["rms_norm"] == counts["rms_norm_bwd"] == gemma * norms
    assert counts["swiglu"] == counts["swiglu_bwd"] == gemma * mlps
    for a, b in zip(T.leaves(sc["params"]), T.leaves(sh["params"])):
        d = (a.cpu() - b).abs()
        assert int((d > 1e-5 * (1 + b.abs())).sum()) <= max(1, b.numel() //
                                                          2000)
        assert float(d.max()) <= 2 * 3e-3


def test_checkpoint_round_trip_of_card_tensors(dev, tmp_path):
    """Card tensors of every dtype the checkpoints carry go to the file
    and back onto the card (or the host, as the `like` says) bitwise."""
    from repro_torch.checkpoint import io as ckpt_io
    tree = {"a": _t(1, 3, 5),
            "b": {"i": torch.arange(7, dtype=torch.int32, device=dev) - 3,
                  "l": torch.tensor(2**40, dtype=torch.int64, device=dev)},
            "q": torch.arange(-4, 4, dtype=torch.int8, device=dev),
            "u": torch.arange(9, dtype=torch.uint8, device=dev)}
    ckpt_io.save(str(tmp_path), tree, step=3, extra={"x": [1, 2]})
    for like in (T.map(torch.zeros_like, tree),
                 T.map(lambda x: torch.zeros_like(x, device="cpu"), tree)):
        got, step, extra = ckpt_io.restore_with_meta(str(tmp_path), like)
        assert step == 3 and extra == {"x": [1, 2]}
        for a, b, w in zip(T.leaves(tree), T.leaves(got), T.leaves(like)):
            assert b.device == w.device and b.dtype == a.dtype
            assert torch.equal(a.cpu(), b.cpu())


def test_observer_snapshot_on_card_does_not_alias_the_next_round(dev):
    """On the card the AdamW kernel updates the state in place: a snapshot
    submitted after round r still holds round r's values when the worker
    stages it after round r+1 has run."""
    import threading

    from repro_torch.core.observer import AsyncObserver
    from repro_torch.optim.lr import make_lr_fn
    cfg = TR.get_smoke_config("starcoder2-3b")
    run = RunConfig(total_steps=8, peak_lr=3e-3, h_base=2, warmup_steps=1,
                    remat=False)
    eng = teng.RoundEngine(cfg, run, workers=2, b_loc=2, seq=8, data="host",
                           layout="flat")
    lr_fn = make_lr_fn(run)
    state, _ = eng.run_round(eng.init_state(), 0, 2, lr_fn)
    want = T.map(lambda x: x.cpu(), state)
    gate, seen = threading.Event(), []

    def handler(step, snap):
        gate.wait(30)
        seen.append(snap)

    obs = AsyncObserver(handler)
    obs.submit(2, state)
    state, _ = eng.run_round(state, 2, 2, lr_fn)
    moved = not all(torch.equal(a, b.cpu()) for a, b in
                    zip(T.leaves(want), T.leaves(state)))
    gate.set()
    obs.close()
    assert moved                     # round r+1 moved the state
    for a, b in zip(T.leaves(want), T.leaves(seen[0])):
        assert b.device.type == "cpu" and torch.equal(a, b)


# whisper-base's attention (8 heads of 64, one kv head each): the encoder's
# bidirectional 1500 frames (forward at B = 4, the backward at a training
# lane's B = 8, whose dS runs in key chunks), the decoder's causal prompt,
# its cross-attention from 32 / 64 prompt rows and from one decode row onto
# the 1500 frames.  (B, Sq, Sk, causal)
WHISPER_ATTN = [(4, 1500, 1500, False), (8, 1500, 1500, False),
                (4, 32, 32, True), (4, 32, 1500, False), (8, 64, 1500, False),
                (4, 1, 1500, False)]


@pytest.mark.parametrize("case", WHISPER_ATTN)
def test_flash_attention_at_whisper_shapes_matches_plain(dev, case):
    b, sq, sk, causal = case
    kw = dict(causal=causal, window=0, prefix_len=0, q_offset=0)
    q, k, v = _t(70, b, sq, 8, 64), _t(71, b, sk, 8, 64), _t(72, b, sk, 8, 64)
    do = _t(73, b, sq, 8, 64)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = t_fa.flash_attention(*ins, **kw)
    want = tref.attention(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=PROD_TOL, atol=PROD_TOL)
    g_got = torch.autograd.grad(got, ins, do)
    del want
    ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    g_want = torch.autograd.grad(tref.attention(*ref_ins, **kw), ref_ins, do)
    for a, b_ in zip(g_got, g_want):
        torch.testing.assert_close(a, b_, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("ring", [None, 30])
def test_flash_decode_at_whisper_shape_matches_plain(dev, ring):
    """whisper-base's decode self-attention: G = 1, D = 64 over a 64-row
    cache, as the cache fills and as a ring after its wrap."""
    q, k, v = _t(80, 4, 1, 8, 64), _t(81, 4, 64, 8, 64), _t(82, 4, 64, 8, 64)
    kpos, qoff = None, [63, 40, 5, 0]
    if ring is not None:
        kpos = torch.arange(64, dtype=torch.int32, device=dev) + ring
        qoff = [93, 93, 93, 93]
    kw = dict(window=0, prefix_len=0, k_positions=kpos,
              q_offset=torch.tensor(qoff, dtype=torch.int32, device=dev))
    torch.testing.assert_close(t_fa.flash_decode(q, k, v, **kw),
                               tref.attention(q, k, v, **kw),
                               rtol=PROD_TOL, atol=PROD_TOL)


def test_whisper_generate_on_card_launches_kernels_and_matches_cpu(dev):
    """whisper-smoke's one-shot generate on the card: the prefill runs an
    attention forward a layer of the encoder and two a decoder layer (self,
    cross), a decode step L flash_decode and L cross forwards, with a ring
    window too; greedy tokens equal the CPU's on the same weights and
    frames."""
    from repro_torch.launch import serve as tserve
    cfg = TR.get_smoke_config("whisper-base")
    card = W.ServingWeights.from_seed(cfg, 0, device=dev)
    host = card.spec.unflatten({b: t.cpu() for b, t in card.bufs.items()})
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 6))
    frames = tserve.audio_frames(cfg, 2, "cpu")
    L, new = cfg.n_layers, 40
    for window in (0, 16):
        ops.reset_launch_counts()
        got = tserve.generate(cfg, card.as_tree(), prompts, gen_len=new,
                              window_override=window, extra=frames)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == {"flash_attention_fwd":
                          cfg.n_enc_layers + 2 * L + L * new,
                          "flash_decode": L * new}
        want = tserve.generate(cfg, host, prompts, gen_len=new,
                               window_override=window, extra=frames)
        assert torch.equal(got.cpu(), want)


def _ssm_norms(cfg):
    """rms_norm launches of one pass of mamba2 / zamba2: two a mamba layer
    (its norm, the gated norm), two a use of zamba2's shared block, the
    final norm; and the shared block's uses."""
    uses = cfg.n_layers // cfg.shared_attn_period \
        if cfg.family == "hybrid" else 0
    return 2 * cfg.n_layers + 2 * uses + 1, uses


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_generate_on_card_launches_kernels_and_matches_cpu(dev, arch):
    """mamba2-smoke's and zamba2-smoke's one-shot generate on the card
    (zamba2 also through a 16-row ring): every norm through rms_norm,
    zamba2's shared block through flash_attention in the prefill and
    flash_decode in a decode step; greedy tokens equal the CPU's on the
    same weights."""
    from repro_torch.launch import serve as tserve
    cfg = TR.get_smoke_config(arch)
    card = W.ServingWeights.from_seed(cfg, 0, device=dev)
    host = card.spec.unflatten({b: t.cpu() for b, t in card.bufs.items()})
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 16))
    norms, uses = _ssm_norms(cfg)
    new = 24
    for window in ((0, 16) if uses else (0,)):
        ops.reset_launch_counts()
        got = tserve.generate(cfg, card.as_tree(), prompts, gen_len=new,
                              window_override=window)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        want = {"rms_norm": norms * (new + 1)}
        if uses:
            want.update(flash_attention_fwd=uses, flash_decode=uses * new)
        assert counts == want
        assert torch.equal(got.cpu(), tserve.generate(
            cfg, host, prompts, gen_len=new, window_override=window))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_loss_and_grads_on_card_match_cpu(dev, arch):
    """mamba2-smoke's and zamba2-smoke's loss and every gradient leaf on the
    card (the norms through `_RmsNorm` and rms_norm_bwd, zamba2's attention
    through the attention kernels) against the CPU's plain versions on the
    same weights and tokens (two 16-token SSD chunks): the loss within
    RMS_TOL, each leaf within GRAD_TOL of its largest |value| (at least
    1)."""
    from repro_torch.models import api, param as pm
    cfg = TR.get_smoke_config(arch)
    mod = api.get_module(cfg)
    host = pm.init_params(mod.param_defs(cfg),
                          torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
             for k in ("tokens", "labels")}
    norms, uses = _ssm_norms(cfg)

    def loss_and_grads(device):
        leaves, treedef = T.flatten(host)
        alias = [x.to(device).requires_grad_(True) for x in leaves]
        loss = mod.loss_fn(cfg, T.unflatten(treedef, alias),
                           {k: v.to(device) for k, v in batch.items()},
                           remat=False)
        return loss, torch.autograd.grad(loss, alias)

    ops.reset_launch_counts()
    loss, grads = loss_and_grads(dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = {"rms_norm": norms, "rms_norm_bwd": norms}
    if uses:
        want.update(flash_attention_fwd=uses, flash_attention_bwd=uses)
    assert counts == want
    wloss, wgrads = loss_and_grads("cpu")
    assert abs(float(loss) - float(wloss)) <= RMS_TOL * max(
        abs(float(wloss)), 1.0)
    for g, w in zip(grads, wgrads):
        assert bool(torch.isfinite(g).all())
        assert float((g.cpu() - w).abs().max()) <= GRAD_TOL * max(
            float(w.abs().max()), 1.0)


# the MoE family's kernel shapes: dbrx-132b's decode attention at G = 6
# (48 query heads over 8 kv heads: the G = 8 instance with g = 6) and
# kimi-k2's at G = 8 (64 over 8), D = 128
@pytest.mark.parametrize("sk", [64, 1089])
@pytest.mark.parametrize("hq", [48, 64])
def test_flash_decode_at_moe_shapes_matches_plain(dev, hq, sk):
    b, hkv, d = 2, 8, 128
    q, k, v = _t(70, b, 1, hq, d), _t(71, b, sk, hkv, d), _t(72, b, sk, hkv, d)
    kw = dict(window=0, prefix_len=0, k_positions=None,
              q_offset=torch.tensor([sk - 1, sk // 2], dtype=torch.int32,
                                    device=dev))
    torch.testing.assert_close(t_fa.flash_decode(q, k, v, **kw),
                               tref.attention(q, k, v, **kw),
                               rtol=PROD_TOL, atol=PROD_TOL)


@pytest.mark.parametrize("hq", [48, 64])
def test_flash_attention_at_moe_shapes_matches_plain(dev, hq):
    """The full-sequence kernels at dbrx's G = 6 and kimi's G = 8 (D = 128,
    causal), forward and backward, at 256 tokens."""
    q, k, v = _t(73, 1, 256, hq, 128), _t(74, 1, 256, 8, 128), \
        _t(75, 1, 256, 8, 128)
    do = _t(76, 1, 256, hq, 128)
    kw = dict(causal=True, window=0, prefix_len=0, q_offset=0)
    o, lse = t_fa.flash_attention_fwd(q, k, v, scale=128 ** -0.5, **kw)
    grads = t_fa.flash_attention_bwd(q, k, v, o, lse, do, scale=128 ** -0.5,
                                     **kw)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = tref.attention(*ins, **kw)
    want_g = torch.autograd.grad(want, ins, do)
    torch.testing.assert_close(o, want.detach(), rtol=PROD_TOL, atol=PROD_TOL)
    for a, b in zip(grads, want_g):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL * max(
            1.0, float(b.abs().max())))


@pytest.mark.parametrize("n", [2, 1024])
def test_kimi_norm_and_shared_expert_under_autograd_match_plain(dev, n):
    """kimi-k2's d = 7168 (rms_norm's staged rows) and its shared expert
    [n, 7168] x [7168, 2048] (swiglu's row kernel at 2 rows, its tiles at
    1024) through `ops` under autograd: one launch of each forward and
    backward kernel, each against autograd of the plain versions."""
    d, f = 7168, 2048
    x, sc, dy = _t(80, n, d), _t(81, d), _t(82, n, d)
    wg, wi = _t(83, d, f, scale=d ** -0.5), _t(84, d, f, scale=d ** -0.5)
    dh = _t(85, n, f)
    ops.reset_launch_counts()
    out, got = _grads_of(ops.rms_norm, (x, sc), dy)
    sout, sgot = _grads_of(ops.swiglu, (x, wg, wi), dh)
    assert {k: v for k, v in ops.launch_counts().items() if v} == dict(
        rms_norm=1, rms_norm_bwd=1, swiglu=1, swiglu_bwd=1)
    torch.testing.assert_close(t_rn.rms_norm(x, sc), out, rtol=0, atol=0)
    torch.testing.assert_close(t_sw.swiglu(x, wg, wi), sout, rtol=0, atol=0)
    wout, want = _grads_of(tref.rms_norm, (x, sc), dy)
    swout, swant = _grads_of(tref.swiglu, (x, wg, wi), dh)
    torch.testing.assert_close(out, wout, rtol=RMS_TOL, atol=RMS_TOL)
    torch.testing.assert_close(got[0], want[0], rtol=RMS_TOL,
                               atol=RMS_TOL * max(1.0, float(
                                   want[0].abs().max())))
    torch.testing.assert_close(got[1], want[1], rtol=0.0,
                               atol=_dscale_tol(x, dy))
    torch.testing.assert_close(sout, swout, rtol=PROD_TOL, atol=PROD_TOL)
    for a, b in zip(sgot, swant):
        torch.testing.assert_close(a, b, rtol=PROD_TOL, atol=PROD_TOL * max(
            1.0, float(b.abs().max())))


def _moe_launches(cfg, attention: str) -> dict:
    """Kernel launches of one pass of an MoE smoke model: attention once a
    layer; an RMSNorm model's rms_norm twice a layer and once at the end;
    the shared expert's swiglu once a layer (the routed experts are
    batched products, no kernel)."""
    out = {attention: cfg.n_layers}
    if cfg.norm == "rmsnorm":
        out["rms_norm"] = 2 * cfg.n_layers + 1
    if cfg.n_shared_experts:
        out["swiglu"] = cfg.n_layers
    return out


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_generate_on_card_launches_kernels_and_matches_cpu(dev, arch):
    """dbrx-smoke's and kimi-smoke's one-shot generate and --slots service
    on the card: greedy tokens equal the CPU's on the same weights, the
    kernels launched as `_moe_launches` says (one prefill, a decode step
    a new token), and a decode step free of device syncs (captured in a
    CUDA graph, replayed to the eager step's logits)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.models import transformer as ttf
    cfg = TR.get_smoke_config(arch)
    card = W.ServingWeights.from_seed(cfg, 0, device=dev)
    host = card.spec.unflatten({b: t.cpu() for b, t in card.bufs.items()})
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
    new = 10
    ops.reset_launch_counts()
    got = tserve.generate(cfg, card.as_tree(), prompts, gen_len=new)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    pre = _moe_launches(cfg, "flash_attention_fwd")
    step = _moe_launches(cfg, "flash_decode")
    want = {k: pre.get(k, 0) + new * step.get(k, 0)
            for k in set(pre) | set(step)}
    assert counts == want
    assert torch.equal(got.cpu(), tserve.generate(cfg, host, prompts,
                                                  gen_len=new))
    b = ContinuousBatcher(cfg, card, slots=2, max_len=24)
    reqs = [Request(rid=i, prompt=p, max_new=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    b.run()
    assert [r.out for r in reqs] == got[:, 12:].cpu().tolist()
    cache = ttf.init_cache(cfg, 2, 24, device=dev)
    tok = torch.zeros(2, dtype=torch.long, device=dev)
    pos = torch.tensor([5, 17], dtype=torch.int32, device=dev)
    tree = card.as_tree()
    with torch.no_grad():
        eager, _ = ttf.decode_step(cfg, tree, tok, cache, pos)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ttf.decode_step(cfg, tree, tok, cache, pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = ttf.decode_step(cfg, tree, tok, cache, pos)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_loss_aux_and_grads_on_card_match_cpu(dev, arch):
    """dbrx-smoke's and kimi-smoke's loss, aux loss and every gradient leaf
    on the card (remat on: the recomputed layers route as the first pass)
    against the CPU's plain versions on the same weights and tokens."""
    from repro_torch.models import api, param as pm
    cfg = TR.get_smoke_config(arch)
    mod = api.get_module(cfg)
    host = pm.init_params(mod.param_defs(cfg),
                          torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))

    def run(device):
        leaves, treedef = T.flatten(host)
        alias = [x.to(device).requires_grad_(True) for x in leaves]
        p = T.unflatten(treedef, alias)
        logits, aux = mod.forward(cfg, p, toks.to(device), remat=True)
        from repro_torch.models import common as cm
        loss = cm.lm_loss(logits, labels.to(device)) \
            + cfg.router_aux_coef * aux
        return loss, aux, torch.autograd.grad(loss, alias)

    ops.reset_launch_counts()
    loss, aux, grads = run(dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    # remat: each layer's forward twice, its backward once
    fwd = _moe_launches(cfg, "flash_attention_fwd")
    want = {k: v + (cfg.n_layers if k != "rms_norm" else 2 * cfg.n_layers)
            for k, v in fwd.items()}
    want["flash_attention_bwd"] = cfg.n_layers
    if "rms_norm" in fwd:
        want["rms_norm_bwd"] = fwd["rms_norm"]
    if "swiglu" in fwd:
        want["swiglu_bwd"] = cfg.n_layers
    assert counts == want
    wloss, waux, wgrads = run("cpu")
    for a, b in ((loss, wloss), (aux, waux)):
        assert abs(float(a.detach()) - float(b.detach())) <= RMS_TOL * max(
            abs(float(b.detach())), 1.0)
    for g, w in zip(grads, wgrads):
        assert float((g.cpu() - w).abs().max()) <= GRAD_TOL * max(
            float(w.abs().max()), 1.0)


# ---------------------------------------------- bf16 buckets, the mesh --

@pytest.mark.parametrize("w,n", [(2, 120), (4, 100_003), (3, 7)])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_flat_update_bf16_matches_plain_bitwise(dev, w, n, quantize,
                                                     momentum):
    """The bf16 instance: bf16 params and anchor, fp32 math, stores rounded
    to nearest even; quantized bitwise the plain version, unquantized
    bitwise its ops in lane order."""
    g = torch.Generator(device=dev).manual_seed(w * 100 + n)
    anchor = (torch.randn(n, generator=g, device=dev) * 0.02).bfloat16()
    p0 = (anchor.float() + torch.randn(w, n, generator=g, device=dev)
          * 1e-3).bfloat16()
    scale = ((torch.randn(n, generator=g, device=dev).abs() + 0.1) * 3e-3
             if quantize else None)
    mu = torch.randn(n, generator=g, device=dev) * 1e-4 if momentum else None
    kw = dict(scale=scale, mu=mu, momentum=momentum)
    plain = tref.sync_flat_update if quantize else \
        tref.sync_flat_update_lane_order
    want = plain(p0, anchor, **kw)
    ops.reset_launch_counts()
    t_su.reset_bf16_launches()
    got = t_su.sync_flat_update(p0.clone(), anchor.clone(), scale=scale,
                                mu=None if mu is None else mu.clone(),
                                momentum=momentum)
    assert t_su.sync_flat_update.bf16_launches == 1
    for x, y in zip(got, want):
        assert (x is None and y is None) or (x.dtype == y.dtype
                                             and torch.equal(x, y))
    assert got[0].dtype == torch.bfloat16


@pytest.mark.parametrize("n", [120, 100_003])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_apply_update_bf16_matches_plain_bitwise(dev, n, quantize,
                                                      momentum):
    step = _t(80, n)
    if quantize:
        step = torch.round(step * 100) / 4
    anchor = _t(81, n).bfloat16()
    scale = (_t(82, n).abs() + 0.1) * 1e-2 if quantize else None
    mu = _t(83, n, scale=1e-3) if momentum else None
    kw = dict(scale=scale, mu=mu, momentum=momentum)
    keep = anchor.clone()
    want = tref.sync_apply_update(step, anchor, **kw)
    got = t_su.sync_apply_update(step, anchor, **kw)
    for x, y in zip(got, want):
        assert (x is None and y is None) or (x.dtype == y.dtype
                                             and torch.equal(x, y))
    assert got[0].dtype == torch.bfloat16 and torch.equal(anchor, keep)


def test_two_gloo_ranks_on_the_card(dev, tmp_path):
    """Two ranks over gloo on the one card (payloads staged through host
    memory): every verb of the probe, then the quantized sync harness on a
    2x1 mesh, each rank's chunks bitwise its host path's, both buckets
    through the sync kernels."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    suite = '[{"mode": "probe"}, {"mode": "sync", "mesh": "2x1", ' \
        '"quantize": true}]'
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--spawn", "2",
         "--mode", "suite", "--device", "cuda", "--backend", "gloo",
         "--suite", suite, "--store-dir", str(tmp_path), "--timeout", "200"],
        cwd=root, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 2 and all(r["ok"] for r in recs)
    for r in recs:
        probe, sync = r["results"]
        assert probe["device"].startswith("cuda") and all(
            probe["checks"].values())
        assert sync["max_abs_diff"] == 0.0
        assert sync["launches"]["sync_flat_update"] > 0
        assert sync["bf16_launches"]["sync_apply_update"] > 0
    assert len({r["results"][1]["digest"] for r in recs}) == 1
