"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips without a card; on the GPU run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the GPU machine has no jax).
Tolerances: the kernels sum in another order than the plain versions, so
fp32 results agree to ~1e-6 relative; 1e-5 (rms_norm) and 2e-5 (products)
leave an order of magnitude of room, 5e-5 for the attention gradients (two
more contractions).  AdamW runs the plain version's op order with every op
rounded on its own, but its bias correction's pow may differ by an ulp:
1e-6.  The quantized sync is held bitwise (integer codes, no FMA).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
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
        (1, 9, 9, 2, 1, 64, True, 0, 0, -4)]       # rows 0-3: no allowed key


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
                                   "adamw_update": 0, "sync_flat_update": 0}
    assert on_card == serve(host)[1]
