"""Why the attention kernels run 3xTF32 and not TF32: a numpy emulation.

`csrc/flash_attention.cu` runs every product on `mma.sync.m16n8k8` with
TF32 operands.  Each fp32 operand x is split into hi = rna_tf32(x) and lo =
rna_tf32(x - hi), and a product accumulates lo*hi + hi*lo + hi*hi in fp32.
Here that arithmetic is emulated on seeded normals at each head dim the
kernel is built for, against an fp64 reference, with chip_smoke.py's
`flash_attention_fwd` tolerance (2e-5 x max(|reference|, 1)): 3xTF32 stays
within it, one TF32 product (hi*hi alone) does not.  The swiglu tile path
(`csrc/swiglu.cu`) sums D = 2560 in 320 k-steps: with the tensor core's
truncating accumulator modelled, a chain over all of them breaks swiglu's
tolerance, and the kernel's zero-started k-steps joined by fp32 adds hold it.
"""
import numpy as np
import pytest

FWD_TOL = 2e-5          # chip_smoke.py TOL["flash_attention_fwd"]
SWIGLU_TOL = 2e-5       # chip_smoke.py TOL["swiglu"]


def rna_tf32(x):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from
    zero (add half of the dropped 13 bits to the magnitude, then drop them)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x.astype(np.float32) - hi)


def mma_dot(a, b, terms):
    """a [M, K] @ b [N, K]^T as the kernel's m16n8k8 loop forms it: per
    8-wide k-step, one fp32 accumulate of each (a-part, b-part) term; the
    products of TF32 values are exact in fp64."""
    c = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k0:k0 + 8].astype(np.float64) @ y[:, k0:k0 + 8].T
            c = (c.astype(np.float64) + step).astype(np.float32)
    return c


def test_rna_tf32_rounds_to_nearest_ties_away_and_split_is_exact():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)              # a TF32 ulp at 1
    assert rna_tf32(one + ulp / 4) == one
    assert rna_tf32(one + ulp * 3 / 4) == one + ulp
    assert rna_tf32(one + ulp / 2) == one + ulp          # tie: away from 0
    assert rna_tf32(-(one + ulp / 2)) == -(one + ulp)
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()     # 10 mantissa bits
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    rest = x.astype(np.float64) - hi - lo                # what the split drops
    assert np.abs(rest).max() <= 2.0 ** -21 * np.abs(x).max()
    # the tile kernels' split drops at most 2^-21 |x| (lo truncated)
    hi, lo = split_lo_truncated(x)
    assert np.array_equal(hi, rna_tf32(x))
    rest = x.astype(np.float64) - hi - lo
    assert (np.abs(rest) <= 2.0 ** -21 * np.abs(x)).all()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_3xtf32_holds_the_attention_tolerance_and_1xtf32_does_not(d):
    rng = np.random.default_rng(d)
    q = rng.standard_normal((64, d)).astype(np.float32)
    k = rng.standard_normal((64, d)).astype(np.float32)
    want = q.astype(np.float64) @ k.astype(np.float64).T
    tol = FWD_TOL * max(float(np.abs(want).max()), 1.0)
    (qh, ql), (kh, kl) = split(q), split(k)
    three = mma_dot(q, k, [(ql, kh), (qh, kl), (qh, kh)])
    one = mma_dot(q, k, [(qh, kh)])
    err3 = float(np.abs(three - want).max())
    err1 = float(np.abs(one - want).max())
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)
    # fp32 itself, summed in the same k-steps, is where 3xTF32 lands
    fp32 = mma_dot(q, k, [(q, k)])
    assert err3 <= 4 * float(np.abs(fp32 - want).max()) + 1e-6


def trunc_f32(x):
    """fp64 -> fp32 rounded toward zero, as the tensor core normalises its
    fp32 accumulator (a model: the hardware also truncates while aligning
    the addends, so it drifts at least this much)."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def split_lo_truncated(x):
    """The tile kernels' split (csrc/tf32_mma.cuh): hi rounded as cvt.rna
    rounds, lo = x - hi as the tensor core reads it (its low 13 bits
    dropped)."""
    hi = rna_tf32(x)
    lo = (x.astype(np.float32) - hi).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def swiglu_tile_dot(x, w, chained):
    """x [M, K] @ w [K, N] as the swiglu tile path's mma.sync loop forms it
    (three TF32 terms per 8-wide k-step, each product truncated into its
    accumulator); `chained` keeps one accumulator over all of K, else each
    k-step starts from zero and joins the running sum by an fp32 add."""
    (xh, xl), (wh, wl) = split_lo_truncated(x), split_lo_truncated(w)
    c = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], 8):
        ks = slice(k0, k0 + 8)
        p = c if chained else np.zeros_like(c)
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            p = trunc_f32(p.astype(np.float64)
                          + a[:, ks].astype(np.float64) @ b[ks])
        c = p if chained else c + p
    return c


def test_swiglu_tile_k_steps_from_zero_hold_the_tolerance_and_a_chain_does_not():
    rng = np.random.default_rng(2560)
    n, d, f = 64, 2560, 128              # gemma3-4b's d_model
    x = rng.standard_normal((n, d)).astype(np.float32)
    wg, wi = ((rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)
              for _ in range(2))

    def act(g, u):
        g, u = np.asarray(g, np.float64), np.asarray(u, np.float64)
        return g / (1.0 + np.exp(-g)) * u

    want = act(x.astype(np.float64) @ wg, x.astype(np.float64) @ wi)
    tol = SWIGLU_TOL * max(float(np.abs(want).max()), 1.0)
    errs = {chained: float(np.abs(act(swiglu_tile_dot(x, wg, chained),
                                      swiglu_tile_dot(x, wi, chained))
                                  - want).max())
            for chained in (False, True)}
    assert errs[False] <= tol, (errs, tol)
    assert errs[True] > tol, (errs, tol)
    # the k-steps from zero land within a few times fp32's own error
    fp32 = float(np.abs(act(x @ wg, x @ wi) - want).max())
    assert errs[False] <= 4 * fp32 + 1e-6, (errs, fp32)
