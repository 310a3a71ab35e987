"""The split plan of the port's `flash_decode` kernel, on the CPU.

`csrc/flash_decode.cu` cuts each (batch row, kv head)'s keys into splits
computed on the card from the row's q_offset, skips the key tiles the row's
mask wholly excludes, and merges the splits' partial softmax states.  The
wrapper module keeps a Python model of that plan (`decode_num_splits`,
`decode_split_plan`, `decode_tiles`), which the kernel never reads; these
tests hold the model (every allowed key covered once, no split empty,
nothing that depends on the batch) and a numpy emulation of split-K + tile
skipping + merge against the JAX package's `ref.attention` and its Pallas
`flash_decode` in interpret mode.  The card tests (`tests/test_torch_cuda.py`)
hold the model against the library's own plan and the kernel itself.

Tolerance: the emulation sums in fp32 in another order than the reference
(per tile, per split, then the merge), ~1e-6 relative; 2e-5 as for every
attention product of the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_decode as j_flash_decode
from repro_torch.kernels import flash_attention as t_fa

PROD_TOL = 2e-5
NEG = np.float32(-1e30)


def _allowed(sk, qpos, *, causal, window, prefix_len, kpos=None):
    """Bool [Sk]: `ref._mask` for one row."""
    kp = np.arange(sk) if kpos is None else np.asarray(kpos)
    valid = kp >= 0
    ok = valid.copy()
    if causal:
        ok &= kp <= qpos
    if window > 0:
        ok &= kp > qpos - window
    if prefix_len:
        ok |= valid & (kp < prefix_len)
    return ok


# (Sk, qpos, causal, window, prefix_len, ring): live, windowed, prefix with a
# gap, rows with no allowed key, ring caches, and Sk across 64-key units up
# to the split cap
ROWS = [(s, q, c, w, p, r)
        for s in (1, 63, 64, 65, 129, 257, 1000, 4097, 9000)
        for q, c, w, p, r in (
            (s - 1, True, 0, 0, False), (s // 2, True, 0, 0, False),
            (s - 1, True, 100, 0, False), (s // 3, True, 64, 30, False),
            (-1, True, 0, 0, False), (s + 500, True, 100, 0, False),
            (-1, True, 0, 5, False), (s // 2, False, 0, 0, False),
            (s // 2, True, 0, 0, True))]


@pytest.mark.parametrize("sk,qpos,causal,window,prefix,ring", ROWS)
def test_split_plan_covers_every_needed_key_once(sk, qpos, causal, window,
                                                 prefix, ring):
    kw = dict(causal=causal, window=window, prefix_len=prefix, ring=ring)
    plan = t_fa.decode_split_plan(sk, qpos, **kw)
    n_max = t_fa.decode_num_splits(sk)
    assert 1 <= len(plan) <= n_max <= t_fa.DECODE_MAX_SPLITS
    # contiguous, ascending, none empty, on 64-key boundaries (the end at Sk)
    for (a0, a1), (b0, _) in zip(plan, plan[1:]):
        assert a1 == b0
    for k0, k1 in plan:
        assert 0 <= k0 < k1 <= sk
        assert k0 % t_fa.DECODE_SPLIT_KEYS == 0
        assert k1 % t_fa.DECODE_SPLIT_KEYS == 0 or k1 == sk
    covered = np.zeros(sk, int)
    for k0, k1 in plan:
        covered[k0:k1] += 1
    assert covered.max() == 1
    ok = _allowed(sk, qpos, causal=causal, window=window, prefix_len=prefix)
    _, _, _, skip = t_fa.decode_allowed(sk, qpos, **kw)
    assert skip == (not ring and bool(ok.any()))
    if skip:           # every allowed key; nothing outside the hull's units
        assert covered[ok].min() == 1
        idx = np.flatnonzero(ok)
        u = t_fa.DECODE_SPLIT_KEYS
        assert plan[0][0] == idx[0] // u * u
        assert plan[-1][1] == min((idx[-1] // u + 1) * u, sk)
    else:              # a ring or a row with no allowed key: all Sk
        assert covered.min() == 1


@pytest.mark.parametrize("sk,qpos,causal,window,prefix,ring", ROWS)
def test_split_tiles_hold_an_allowed_key_unless_walking_all(sk, qpos, causal,
                                                            window, prefix,
                                                            ring):
    kw = dict(causal=causal, window=window, prefix_len=prefix, ring=ring)
    ok = _allowed(sk, qpos, causal=causal, window=window, prefix_len=prefix)
    skip = t_fa.decode_allowed(sk, qpos, **kw)[3]
    for d in (64, 256, 1024):
        tile = t_fa.decode_tile_keys(d)
        assert t_fa.DECODE_SPLIT_KEYS % tile == 0
        seen = np.zeros(sk, bool)
        for k0, k1 in t_fa.decode_split_plan(sk, qpos, **kw):
            tiles = t_fa.decode_tiles(k0, k1, tile, sk, qpos, **kw)
            assert tiles == sorted(set(tiles))
            for t in tiles:
                assert k0 <= t < k1 and t % tile == 0
                seen[t:t + tile] = True
                if skip:
                    assert ok[t:t + tile].any()
            if not skip:
                assert tiles == list(range(k0, k1, tile))
        assert seen[ok].all() if skip else seen.all()


def test_split_count_depends_on_sk_alone():
    """The number of blocks per (batch row, kv head) is a function of Sk:
    one per 2 units of 64 keys, at most 64; a batch of rows sees each row's
    plan exactly as the row alone does (the plan takes no batch size)."""
    assert [t_fa.decode_num_splits(s) for s in (1, 64, 65, 128, 129, 4096,
                                                8192, 8193, 10 ** 6)] == \
        [1, 1, 1, 1, 2, 32, 64, 64, 64]
    qpos = [(s + 1) * 512 - 1 for s in range(8)]
    batch = [t_fa.decode_split_plan(4096, q, window=1024) for q in qpos]
    assert batch[3] == t_fa.decode_split_plan(4096, qpos[3], window=1024)
    assert [len(p) for p in batch] == [4, 8, 8, 8, 8, 8, 8, 8]
    glob = [len(t_fa.decode_split_plan(4096, q)) for q in qpos]
    assert glob == [4, 8, 12, 16, 20, 24, 28, 32]


def _online(state, s, vr):
    """One online-softmax update of (m, l, acc) by scores s [g, n] (-inf:
    weight 0) and V rows vr [n, d]; zero weights never multiply V."""
    m, l, acc = state
    m_new = np.maximum(m, s.max(1))
    with np.errstate(invalid="ignore"):
        al = np.where(np.isneginf(m_new), 1, np.exp(m - m_new))
        p = np.where(np.isneginf(s), 0, np.exp(s - m_new[:, None]))
        pv = np.where((p != 0)[:, :, None], p[:, :, None] * vr[None], 0)
    return (m_new, (l * al + p.sum(1)).astype(np.float32),
            (acc * al[:, None] + pv.sum(1)).astype(np.float32))


def _join(states):
    """(m, l, acc) of several partial states, joined in order with weights
    exp(m_i - M); a state with m = -inf adds nothing."""
    live = [st for st in states if not np.isneginf(st[0]).all()]
    if not live:
        return states[0]
    mx = np.max([st[0] for st in live], axis=0)
    den = np.zeros_like(live[0][1])
    num = np.zeros_like(live[0][2])
    for m, l, acc in live:
        w = np.where(np.isneginf(m), 0, np.exp(m - mx)).astype(np.float32)
        den += w * l
        num += w[:, None] * acc
    return mx, den, num


def emulate(q, k, v, qoff, *, causal=True, window=0, prefix_len=0,
            kpos=None, scale=None, per_warp=False):
    """numpy fp32 emulation of the kernel: per (row, kv head) the splits of
    `decode_split_plan`, each walking the tiles of `decode_tiles` with the
    online softmax, partials (m, l, acc) joined in split order.  The
    block-wide loop updates one state per tile (masked scores -1e30, keys
    past Sk -inf); with `per_warp` each of 8 warps owns tile / 8 keys of
    every tile and its own state (a live row's masked keys -inf), and the
    warps' states join in warp order.  A row in one split divides by l
    itself."""
    b, _, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = np.float32(d ** -0.5 if scale is None else scale)
    tile = t_fa.decode_tile_keys(d)
    ring = kpos is not None
    warps = 8 if per_warp else 1
    out = np.zeros_like(q)
    for bi in range(b):
        qpos = int(qoff[bi])
        kw = dict(causal=causal, window=window, prefix_len=prefix_len,
                  ring=ring)
        skip = t_fa.decode_allowed(sk, qpos, **kw)[3]
        masked = -np.inf if per_warp and skip else NEG
        ok_all = _allowed(sk, qpos, causal=causal, window=window,
                          prefix_len=prefix_len, kpos=kpos)
        for h in range(hkv):
            qg = q[bi, 0, h * g:(h + 1) * g]                       # [g, d]
            parts = []
            for k0, k1 in t_fa.decode_split_plan(sk, qpos, **kw):
                init = (np.full(g, -np.inf if per_warp else NEG, np.float32),
                        np.zeros(g, np.float32),
                        np.zeros((g, d), np.float32))
                states = [init] * warps
                tiles = t_fa.decode_tiles(k0, k1, tile, sk, qpos, **kw)
                for t in tiles:
                    for w in range(warps):
                        j = t + np.arange(w * tile // warps,
                                          (w + 1) * tile // warps)
                        inr = j < sk
                        jj = np.minimum(j, sk - 1)
                        with np.errstate(invalid="ignore"):
                            dot = (qg @ k[bi, jj, h].T).astype(np.float32)
                        s = np.where((inr & ok_all[jj])[None], dot * scale,
                                     masked)
                        s = np.where(inr[None], s, -np.inf).astype(np.float32)
                        states[w] = _online(states[w], s, v[bi, jj, h])
                m, l, acc = _join(states)
                if not tiles:                # nothing walked: merge skips it
                    m = np.full(g, -np.inf, np.float32)
                parts.append((m, l, acc))
            m, l, acc = parts[0] if len(parts) == 1 else _join(parts)
            out[bi, 0, h * g:(h + 1) * g] = acc / np.where(l == 0, 1, l)[:, None]
    return out


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (name, B, Sk, Hkv, g, D, window, prefix_len, q_offset, ring shift | None)
EMU_CASES = [
    ("causal", 3, 200, 2, 2, 16, 0, 0, [199, 70, 5], None),
    ("window", 3, 300, 2, 2, 16, 64, 0, [299, 150, 30], None),
    ("prefix-gap", 3, 260, 1, 4, 16, 32, 10, [259, 100, 3], None),
    ("ring", 3, 150, 2, 2, 16, 40, 0, [349, 300, 250], 200),
    ("no-valid-key", 3, 130, 2, 2, 16, 64, 0, [-1, 260, 50], None),
    ("d256-long", 2, 700, 1, 2, 256, 0, 0, [699, 333], None),
    ("d1024", 2, 140, 1, 2, 1024, 20, 3, [139, 70], None),
    ("gqa12", 2, 300, 2, 12, 32, 64, 5, [299, 100], None),
]


def _inputs(b, sk, hkv, g, d, ring, seed=0):
    q, k, v = _np(seed + 1, b, 1, hkv * g, d), _np(seed + 2, b, sk, hkv, d), \
        _np(seed + 3, b, sk, hkv, d)
    kpos = None
    if ring is not None:
        kpos = (np.arange(sk) + ring).astype(np.int32)
        kpos[2::5] = -1
    return q, k, v, kpos


@pytest.mark.parametrize("per_warp", [False, True], ids=["block", "warp"])
@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_emulated_split_decode_matches_jax_ref_and_pallas(case, per_warp):
    _, b, sk, hkv, g, d, window, prefix, qoff, ring = case
    q, k, v, kpos = _inputs(b, sk, hkv, g, d, ring)
    qo = np.asarray(qoff, np.int32)
    got = emulate(q, k, v, qo, window=window, prefix_len=prefix, kpos=kpos,
                  per_warp=per_warp)
    jkw = dict(causal=True, window=window, prefix_len=prefix,
               q_offset=jnp.asarray(qo),
               k_positions=None if kpos is None else jnp.asarray(kpos))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jref.attention(jq, jk, jv,
                                                              **jkw)),
                               rtol=PROD_TOL, atol=PROD_TOL)
    # the Pallas kernel differs on rows with no allowed key (sum(V) / padded
    # Sk, not the mean): it is held on the others
    live = [i for i in range(b)
            if _allowed(sk, qoff[i], causal=True, window=window,
                        prefix_len=prefix, kpos=kpos).any()]
    pal = np.asarray(j_flash_decode(jq, jk, jv, interpret=True, block_k=16,
                                    **jkw))
    np.testing.assert_allclose(got[live], pal[live], rtol=PROD_TOL,
                               atol=PROD_TOL)
    # and the plain version the CPU serving path runs
    tkw = dict(window=window, prefix_len=prefix,
               q_offset=torch.from_numpy(qo),
               k_positions=None if kpos is None else torch.from_numpy(kpos))
    np.testing.assert_allclose(
        got, t_fa.plain(*map(torch.from_numpy, (q, k, v)), **tkw).numpy(),
        rtol=PROD_TOL, atol=PROD_TOL)


@pytest.mark.parametrize("per_warp", [False, True], ids=["block", "warp"])
@pytest.mark.parametrize("case", [c for c in EMU_CASES if c[-1] is None
                                  and c[0] != "no-valid-key"],
                         ids=lambda c: c[0])
def test_emulated_skipping_never_reads_masked_rows(case, per_warp):
    """K and V rows outside each row's allowed keys hold NaN: the walked
    tiles and the zero-weight rule never touch them, so the emulation's
    output is finite and equals the reference with those rows zeroed."""
    _, b, sk, hkv, g, d, window, prefix, qoff, _ = case
    q, k, v, _ = _inputs(b, sk, hkv, g, d, None, seed=10)
    kn, vn, kz, vz = k.copy(), v.copy(), k.copy(), v.copy()
    for i in range(b):
        bad = ~_allowed(sk, qoff[i], causal=True, window=window,
                        prefix_len=prefix)
        kn[i, bad], vn[i, bad], kz[i, bad], vz[i, bad] = np.nan, np.nan, 0, 0
    qo = np.asarray(qoff, np.int32)
    got = emulate(q, kn, vn, qo, window=window, prefix_len=prefix,
                  per_warp=per_warp)
    assert np.isfinite(got).all()
    want = jref.attention(*map(jnp.asarray, (q, kz, vz)), causal=True,
                          window=window, prefix_len=prefix,
                          q_offset=jnp.asarray(qo))
    np.testing.assert_allclose(got, np.asarray(want), rtol=PROD_TOL,
                               atol=PROD_TOL)


@pytest.mark.parametrize("per_warp", [False, True], ids=["block", "warp"])
def test_emulated_rows_are_independent_of_the_batch(per_warp):
    """Each row emulated in a batch of 4 equals the row emulated alone,
    bitwise: nothing in the plan or the merge reads another row."""
    q, k, v, _ = _inputs(4, 300, 2, 2, 16, None, seed=20)
    qo = np.asarray([299, 120, -1, 64], np.int32)
    batch = emulate(q, k, v, qo, window=100, prefix_len=7, per_warp=per_warp)
    for i in range(4):
        alone = emulate(q[i:i + 1], k[i:i + 1], v[i:i + 1], qo[i:i + 1],
                        window=100, prefix_len=7, per_warp=per_warp)
        np.testing.assert_array_equal(batch[i:i + 1], alone)
