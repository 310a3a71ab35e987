"""The port's plain kernel versions against the JAX package's.

Each plain PyTorch version (`repro_torch/kernels/ref.py`, what a CPU tensor
runs) is held against the JAX `ref.py` function AND the JAX Pallas kernel
run in interpret mode, on the same numpy inputs made from a seed.  The
dispatch seam (`kernels/ops.py`) is checked to send CPU tensors to the plain
versions and never to a kernel.  The CUDA kernels themselves are held
against these plain versions on the card by `tests/test_torch_cuda.py`.

Tolerances are fp32: the two packages sum in different orders (XLA's CPU
reductions vs torch's), so rms_norm agrees to ~1e-6 relative and the
products in swiglu/attention to ~1e-6 per contraction; the stated bounds
(1e-5 and 2e-5) leave an order of magnitude of room.  The attention
gradients go through two more contractions (dP = dO V^T, then dS K or
dS^T Q): 5e-5.  The elementwise AdamW and sync updates run the same fp32
ops in the same order on both sides; they differ only where XLA contracts
a multiply-add into an FMA or rounds a pow differently (a few ulps): 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.adamw_update import adamw_update as j_adamw_update
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_attention import flash_decode as j_flash_decode
from repro.kernels.rmsnorm import rms_norm as j_rms_norm
from repro.kernels.swiglu import swiglu as j_swiglu
from repro.kernels.sync_update import sync_flat_update as j_sync_flat_update
from repro_torch.errors import ConfigError, ShapeError
from repro_torch.kernels import adamw_update as t_ad
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as t_rn
from repro_torch.kernels import swiglu as t_sw
from repro_torch.kernels import sync_update as t_su
from torch_one_thread import one_torch_thread  # noqa: F401

RMS_TOL = 1e-5       # relative; fp32 mean-of-squares in another order
PROD_TOL = 2e-5      # swiglu / attention: fp32 contractions in another order
GRAD_TOL = 5e-5      # attention gradients: two more contractions
ELEM_TOL = 1e-6      # AdamW / sync: same elementwise ops, FMA / pow ulps


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- rms_norm --

@pytest.mark.parametrize("shape", [(4, 128), (2, 33, 256), (5, 384),
                                   (4, 2560)])
def test_rms_norm_matches_jax_ref_and_pallas(shape):
    x, sc = _np(1, *shape), 1.0 + 0.1 * _np(2, shape[-1])
    got = tref.rms_norm(torch.from_numpy(x), torch.from_numpy(sc)).numpy()
    _close(got, jref.rms_norm(jnp.asarray(x), jnp.asarray(sc)), RMS_TOL)
    _close(got, j_rms_norm(jnp.asarray(x), jnp.asarray(sc), interpret=True),
           RMS_TOL)


# ------------------------------------------------------------------ swiglu --

@pytest.mark.parametrize("n,d,f", [(4, 64, 128), (7, 96, 64), (256, 64, 96),
                                   (2, 256, 512), (9, 98, 96), (129, 64, 128),
                                   (129, 98, 516)])
def test_swiglu_matches_jax_ref_and_pallas(n, d, f):
    x = _np(3, n, d)
    wg, wi = _np(4, d, f, scale=d ** -0.5), _np(5, d, f, scale=d ** -0.5)
    got = tref.swiglu(*map(torch.from_numpy, (x, wg, wi))).numpy()
    jx, jg, ji = map(jnp.asarray, (x, wg, wi))
    _close(got, jref.swiglu(jx, jg, ji), PROD_TOL)
    _close(got, j_swiglu(jx, jg, ji, interpret=True, block_r=64, block_f=64),
           PROD_TOL)


# --------------------------------------------------------------- attention --

def _ring_positions(sk, shift):
    """Absolute positions of a ring cache, every 6th slot empty (-1)."""
    kpos = np.arange(sk, dtype=np.int32) + shift
    kpos[1::6] = -1
    return kpos


# (name, B, Sk, Hkv, g, D, window, prefix_len, q_offset, ring shift | None)
# Every row has at least one valid key (see test_no_valid_key_rows_...).
DECODE_CASES = [
    ("mha", 2, 40, 2, 1, 16, 0, 0, [39, 39], None),
    ("gqa2-window", 2, 37, 2, 2, 32, 8, 0, [36, 20], None),
    ("gqa4-ragged", 3, 50, 1, 4, 16, 0, 0, [3, 49, 17], None),
    ("gqa2-prefix", 2, 45, 2, 2, 16, 6, 5, [44, 30], None),
    ("gqa4-window-ragged", 2, 33, 2, 4, 32, 16, 0, [12, 32], None),
    ("ring", 2, 24, 2, 2, 16, 10, 0, [60, 45], 40),
    ("ring-prefix", 2, 29, 1, 4, 16, 10, 3, [70, 40], 0),
    ("scalar-offset", 2, 21, 2, 2, 16, 0, 0, 20, None),
    ("gqa12-window", 2, 40, 2, 12, 32, 16, 3, [39, 20], None),
]


def _decode_inputs(b, sk, hkv, g, d, qoff, ring, seed=0):
    q = _np(seed + 10, b, 1, hkv * g, d)
    k = _np(seed + 11, b, sk, hkv, d)
    v = _np(seed + 12, b, sk, hkv, d)
    kpos = None if ring is None else _ring_positions(sk, ring)
    return q, k, v, np.asarray(qoff, np.int32), kpos


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention_matches_jax_ref_and_pallas(case):
    _, b, sk, hkv, g, d, window, prefix, qoff, ring = case
    q, k, v, qo, kpos = _decode_inputs(b, sk, hkv, g, d, qoff, ring)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    got = tref.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), q_offset=torch.from_numpy(qo),
                         k_positions=None if kpos is None
                         else torch.from_numpy(kpos), **kw).numpy()
    jkw = dict(kw, q_offset=jnp.asarray(qo),
               k_positions=None if kpos is None else jnp.asarray(kpos))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.attention(jq, jk, jv, **jkw), PROD_TOL)
    # block_k=16 leaves a ragged last key block whenever Sk % 16 != 0
    _close(got, j_flash_decode(jq, jk, jv, interpret=True, block_k=16,
                               **jkw), PROD_TOL)


@pytest.mark.parametrize("sq,window,prefix", [(5, 0, 0), (6, 3, 0), (4, 0, 2)])
def test_full_sequence_attention_matches_jax_ref(sq, window, prefix):
    """The plain version also covers Sq > 1 (the CPU side of the training
    slice's kernel), with a static offset."""
    q, k, v = _np(20, 2, sq, 4, 16), _np(21, 2, sq + 3, 2, 16), \
        _np(22, 2, sq + 3, 2, 16)
    kw = dict(causal=True, window=window, prefix_len=prefix, q_offset=3)
    got = tref.attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    _close(got, jref.attention(*map(jnp.asarray, (q, k, v)), **kw), PROD_TOL)


def test_no_valid_key_rows_follow_jax_ref():
    """A row whose keys are all masked gets the mean of V over the Sk keys,
    as `ref.attention` gives it (the masked scores are the finite -1e30).
    The Pallas kernel differs there (sum(V) / padded Sk), so it is held
    only on rows with at least one valid key, above."""
    q, k, v, qo, _ = _decode_inputs(2, 9, 2, 2, 16, [4, 4], None)
    kpos = np.full(9, -1, np.int32)
    got = tref.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), q_offset=torch.from_numpy(qo),
                         k_positions=torch.from_numpy(kpos)).numpy()
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_offset=jnp.asarray(qo),
                          k_positions=jnp.asarray(kpos))
    _close(got, want, PROD_TOL)
    mean_v = v.mean(axis=1)                               # [B,Hkv,D]
    _close(got[:, 0], np.repeat(mean_v, 2, axis=1), PROD_TOL)


@pytest.mark.parametrize("sq,sk,causal,window,prefix,qoff", [
    (1, 12, True, 0, 0, 11), (3, 10, True, 4, 0, 7), (2, 8, False, 0, 0, 0),
    (1, 15, True, 5, 3, 14)])
def test_mask_matches_jax_mask(sq, sk, causal, window, prefix, qoff):
    got = tref._mask(sq, sk, causal=causal, window=window, prefix_len=prefix,
                     q_offset=qoff).numpy()
    want = jref._mask(sq, sk, causal=causal, window=window, prefix_len=prefix,
                      q_offset=qoff)
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------- full-sequence attention ------

# (name, B, Sq, Sk, Hkv, g, D, causal, window, prefix_len, q_offset).  Every
# query row keeps at least one allowed key (the Pallas kernel differs from
# `ref.attention` on rows with none; test_no_valid_key_rows_follow_jax_ref).
FULL_CASES = [
    ("noncausal", 2, 20, 20, 4, 1, 16, False, 0, 0, 0),
    ("noncausal-vit-like", 2, 13, 13, 3, 1, 64, False, 0, 0, 0),
    ("causal", 2, 37, 37, 2, 1, 16, True, 0, 0, 0),
    ("causal-gqa2", 2, 30, 30, 2, 2, 32, True, 0, 0, 0),
    ("window", 2, 33, 33, 2, 1, 16, True, 8, 0, 0),
    ("prefix-gqa2", 2, 29, 29, 1, 2, 16, True, 0, 7, 0),
    ("q-offset", 2, 12, 37, 2, 1, 16, True, 0, 0, 25),
    ("q-offset-window-gqa2", 1, 17, 40, 2, 2, 16, True, 6, 0, 23),
]
FULL_IDS = [c[0] for c in FULL_CASES]


def _jax_attention_grads(q, k, v, w, kw):
    """jax.grad of sum(ref.attention(q, k, v) * w) w.r.t. (q, k, v), jitted
    (one compile instead of one per primitive)."""
    fn = jax.jit(jax.grad(lambda q_, k_, v_, w_: jnp.sum(
        jref.attention(q_, k_, v_, **kw) * w_), argnums=(0, 1, 2)))
    return fn(*map(jnp.asarray, (q, k, v, w)))


def _full_inputs(b, sq, sk, hkv, g, d, seed=30):
    return (_np(seed, b, sq, hkv * g, d), _np(seed + 1, b, sk, hkv, d),
            _np(seed + 2, b, sk, hkv, d), _np(seed + 3, b, sq, hkv * g, d))


@pytest.mark.parametrize("case", FULL_CASES, ids=FULL_IDS)
def test_full_attention_matches_jax_ref_and_pallas(case):
    """The plain version (what CPU tensors run, and what the CUDA kernel is
    held against on the card) equals `ref.attention` and the Pallas
    `flash_attention` in interpret mode; block 16 leaves ragged last q and
    k blocks whenever Sq or Sk % 16 != 0."""
    _, b, sq, sk, hkv, g, d, causal, window, prefix, qoff = case
    q, k, v, _ = _full_inputs(b, sq, sk, hkv, g, d)
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_offset=qoff)
    got = tref.attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.attention(jq, jk, jv, **kw), PROD_TOL)
    _close(got, j_flash_attention(jq, jk, jv, interpret=True, block_q=16,
                                  block_k=16, **kw), PROD_TOL)


@pytest.mark.parametrize("case", FULL_CASES, ids=FULL_IDS)
def test_full_attention_grads_match_jax_grad_of_ref(case):
    """dq/dk/dv of the plain version (torch autograd — the gradient the
    CUDA backward kernel is held against) equal `jax.grad` of
    `ref.attention`: JAX cannot differentiate its Pallas kernel."""
    _, b, sq, sk, hkv, g, d, causal, window, prefix, qoff = case
    q, k, v, w = _full_inputs(b, sq, sk, hkv, g, d)
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_offset=qoff)
    want = _jax_attention_grads(q, k, v, w, kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tref.attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt, GRAD_TOL)


def test_no_valid_key_rows_have_uniform_weights_in_the_gradient():
    """A row with no allowed key has P = 1/Sk and no score gradient in
    `ref.attention`'s autograd (the masked scores are a constant): the
    semantics the CUDA backward reproduces."""
    q, k, v, w = _full_inputs(1, 6, 6, 1, 1, 16)
    kw = dict(causal=True, window=0, prefix_len=0, q_offset=-3)
    want = _jax_attention_grads(q, k, v, w, kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = torch.autograd.grad((tref.attention(tq, tk, tv, **kw)
                               * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for gt, wt in zip(got, want):
        _close(gt.numpy(), wt, GRAD_TOL)
    assert np.abs(got[0].numpy()[0, :3]).max() == 0.0   # rows 0-2: no key


# --------------------------------------------------------------- optimizer --

@pytest.mark.parametrize("shape,step", [((1000,), 1), ((3, 257), 7),
                                        ((4, 8, 33), 200)])
def test_adamw_update_matches_jax_ref_and_pallas(shape, step):
    p, m, g = _np(40, *shape), _np(41, *shape, scale=0.1), _np(42, *shape)
    v = np.abs(_np(43, *shape, scale=0.01))
    kw = dict(lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.05,
              step=step)
    got = tref.adamw_update(*map(torch.from_numpy, (p, m, v, g)), **kw)
    jargs = tuple(map(jnp.asarray, (p, m, v, g)))
    jkw = dict(kw, step=jnp.float32(step))
    for want in (jref.adamw_update(*jargs, **jkw),
                 j_adamw_update(*jargs, interpret=True, **jkw)):
        for gt, wt in zip(got, want):
            _close(gt.numpy(), wt, ELEM_TOL)


# -------------------------------------------------------------------- sync --

# W = 1, 3 and 8 are instances of the card's kernel of their own, and n %
# 4 = 1..3 its scalar pass (the card holds its bits to these versions)
@pytest.mark.parametrize("w,n", [(2, 300), (4, 5000)] + [
    (w, n) for w in (1, 3, 8) for n in (301, 302, 303)])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_flat_update_matches_jax_ref_and_pallas(w, n, quantize,
                                                     momentum):
    rng = np.random.RandomState(n + w)
    p = rng.randn(w, n).astype(np.float32)
    anchor = rng.randn(n).astype(np.float32)
    scale = (np.abs(rng.randn(n)) + 0.1).astype(np.float32) if quantize \
        else None
    mu = rng.randn(n).astype(np.float32) if momentum else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    kw = dict(scale=t(scale), mu=t(mu), momentum=momentum)
    got = tref.sync_flat_update(t(p), t(anchor), **kw)
    in_order = tref.sync_flat_update_lane_order(t(p), t(anchor), **kw)
    for want in (jref.sync_flat_update(j(p), j(anchor), scale=j(scale),
                                       mu=j(mu), momentum=momentum),
                 j_sync_flat_update(j(p), j(anchor), scale=j(scale),
                                    mu=j(mu), momentum=momentum,
                                    interpret=True)):
        for gt, ot, wt in zip(got, in_order, want):
            if wt is None:
                assert gt is None and ot is None
                continue
            _close(gt.numpy(), wt, ELEM_TOL)
            _close(ot.numpy(), wt, ELEM_TOL)
    if quantize:
        # integer codes: their sum is exact in any order
        for gt, ot in zip(got, in_order):
            assert (gt is None and ot is None) or torch.equal(gt, ot)
    if quantize and not momentum and w & (w - 1) == 0:
        # integer codes: the code sum is exact, the result bitwise JAX's;
        # jnp.mean multiplies by the rounded 1/W where the port divides by
        # W, which agree when W is a power of two
        np.testing.assert_array_equal(
            got[1].numpy(), np.asarray(jref.sync_flat_update(
                j(p), j(anchor), scale=j(scale))[1]))


def test_quantize_codes_round_half_to_even():
    d = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0]) / 127.0
    got = tref.quantize_codes(d, torch.tensor(1.0))
    want = jnp.clip(jnp.round(jnp.asarray(d.numpy()) / 1.0 * 127.0), -127, 127)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- dispatch --

def test_ops_cpu_tensors_take_the_plain_versions():
    """CPU tensors run the plain versions; no kernel launches are counted."""
    ops.reset_launch_counts()
    x, sc = torch.from_numpy(_np(1, 3, 64)), torch.ones(64)
    wg, wi = torch.from_numpy(_np(2, 64, 32)), torch.from_numpy(_np(3, 64, 32))
    q, k, v, qo, _ = _decode_inputs(2, 11, 2, 2, 16, [10, 4], None)
    q, k, v, qo = map(torch.from_numpy, (q, k, v, qo))
    torch.testing.assert_close(ops.rms_norm(x, sc), tref.rms_norm(x, sc),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.swiglu(x, wg, wi), tref.swiglu(x, wg, wi),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, window=4, q_offset=qo),
        tref.attention(q, k, v, window=4, q_offset=qo), rtol=0, atol=0)
    p, m, v, g = (torch.from_numpy(_np(i, 3, 7)) for i in range(4))
    v = v.abs()
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.05,
              step=3)
    for got, want in zip(ops.adamw_update(p, m, v, g, **kw),
                         tref.adamw_update(p, m, v, g, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    qf = torch.from_numpy(_np(5, 2, 9, 4, 64))
    torch.testing.assert_close(
        ops.flash_attention(qf, qf, qf, causal=False),
        tref.attention(qf, qf, qf, causal=False), rtol=0, atol=0)
    a, sc = torch.from_numpy(_np(6, 7)), torch.ones(7)
    for got, want in zip(ops.sync_flat_update(p, a, scale=sc),
                         tref.sync_flat_update(p, a, scale=sc)):
        assert (got is None and want is None) or torch.equal(got, want)
    assert set(ops.launch_counts()) == {
        "rms_norm", "swiglu", "rms_norm_bwd", "swiglu_bwd", "flash_decode",
        "flash_attention_fwd",
        "flash_attention_bwd", "adamw_update", "sync_flat_update",
        "sync_apply_update", "ring_combine", "ring_quantize"}
    assert set(ops.launch_counts().values()) == {0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never computes on the CPU
    itself, so a CPU tensor handed to it directly is an error."""
    x = torch.zeros(2, 8)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_rn.rms_norm(x, torch.ones(8))
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_sw.swiglu(x, torch.zeros(8, 4), torch.zeros(8, 4))
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_fa.flash_decode(torch.zeros(1, 1, 2, 8), torch.zeros(1, 3, 1, 8),
                          torch.zeros(1, 3, 1, 8))
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_fa.flash_attention(q, q, q)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_fa.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 4), q,
                                 causal=True, window=0, prefix_len=0,
                                 q_offset=0, scale=0.125)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_ad.adamw_update(x, x, x, x, lr=1e-3, beta1=0.9, beta2=0.999,
                          eps=1e-8, weight_decay=0.0, step=1)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_su.sync_flat_update(x, torch.zeros(8))
    assert t_rn.plain is tref.rms_norm and t_sw.plain is tref.swiglu
    assert t_fa.plain is tref.attention
    assert t_ad.plain is tref.adamw_update
    assert t_su.plain is tref.sync_flat_update


def test_ops_rejects_devices_without_a_kernel():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ConfigError, match="no kernel for device"):
        ops.rms_norm(x, torch.ones(8, device="meta"))


@pytest.mark.parametrize("n", [7, ops.CPU_ADAMW_CHUNK,
                               2 * ops.CPU_ADAMW_CHUNK + 5])
def test_cpu_adamw_in_chunks_is_bitwise_the_plain_version(n):
    """On the CPU the dispatch seam runs the plain AdamW in chunks of
    CPU_ADAMW_CHUNK elements (a leaf's passes then stay in cache): the same
    bits, dtypes and shapes as one call over the whole leaf."""
    rng = np.random.default_rng(n)
    shape = (2, (n + 1) // 2)
    p, m, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    v = torch.from_numpy(rng.random(shape).astype(np.float32)) * 1e-3
    kw = dict(lr=torch.tensor(3e-3), beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=torch.tensor(3.0))
    for got, want in zip(ops.adamw_update(p, m, v, g, **kw),
                         tref.adamw_update(p, m, v, g, **kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
