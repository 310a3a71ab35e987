"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips without a card; on the GPU run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the GPU machine has no jax).
Tolerances: the kernels sum in another order than the plain versions, so
fp32 results agree to ~1e-6 relative; 1e-5 (rms_norm) and 2e-5 (products)
leave an order of magnitude of room, 5e-5 for the attention gradients (two
more contractions).  AdamW runs the plain version's op order with every op
rounded on its own, but its bias correction's pow may differ by an ulp:
1e-6.  The quantized sync, the split sync's apply and the ring's combine
and quantize are held bitwise (integer codes, every op rounded on its own,
no FMA).  Training on the card against the CPU: see
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


@pytest.mark.parametrize("n", [1, 2, 5, 300])
def test_swiglu_and_rms_norm_match_plain(dev, n):
    x = _t(1, n, 256)
    wg, wi = _t(2, 256, 96, scale=1 / 16), _t(3, 256, 96, scale=1 / 16)
    sc = _t(4, 256)
    torch.testing.assert_close(t_sw.swiglu(x, wg, wi), tref.swiglu(x, wg, wi),
                               rtol=PROD_TOL, atol=PROD_TOL)
    torch.testing.assert_close(t_rn.rms_norm(x, sc), tref.rms_norm(x, sc),
                               rtol=RMS_TOL, atol=RMS_TOL)


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


def test_flash_decode_no_valid_key_gives_mean_of_v(dev):
    q, k, v = _t(1, 2, 1, 4, 64), _t(2, 2, 37, 2, 64), _t(3, 2, 37, 2, 64)
    kpos = torch.full((37,), -1, dtype=torch.int32, device=dev)
    got = t_fa.flash_decode(q, k, v, k_positions=kpos, q_offset=5)
    torch.testing.assert_close(got, tref.attention(q, k, v, k_positions=kpos,
                                                   q_offset=5),
                               rtol=PROD_TOL, atol=PROD_TOL)
    torch.testing.assert_close(got[:, 0], v.mean(1).repeat_interleave(2, 1),
                               rtol=PROD_TOL, atol=PROD_TOL)


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
        t_fa.flash_decode(_t(1, 1, 1, 16, 16), _t(2, 1, 3, 1, 16),
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
        (1, 65, 65, 4, 1, 64, True, 0, 0, -30)]    # rows 0-29: no allowed key


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
