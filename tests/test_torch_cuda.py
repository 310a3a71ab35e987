"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips without a card; on the GPU run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (the GPU machine has no jax).
Tolerances: the kernels sum in another order than the plain versions, so
fp32 results agree to ~1e-6 relative; 1e-5 (rms_norm) and 2e-5 (products)
leave an order of magnitude of room.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as TR
from repro_torch.errors import ShapeError
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as t_rn
from repro_torch.kernels import swiglu as t_sw
from repro_torch.launch import weights as W
from repro_torch.launch.batching import ContinuousBatcher, Request

RMS_TOL = 1e-5
PROD_TOL = 2e-5

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
                                   "flash_decode": L * steps}
    assert on_card == serve(host)[1]
