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
(1e-5 and 2e-5) leave an order of magnitude of room.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_decode as j_flash_decode
from repro.kernels.rmsnorm import rms_norm as j_rms_norm
from repro.kernels.swiglu import swiglu as j_swiglu
from repro_torch.errors import ConfigError, ShapeError
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as t_rn
from repro_torch.kernels import swiglu as t_sw

RMS_TOL = 1e-5       # relative; fp32 mean-of-squares in another order
PROD_TOL = 2e-5      # swiglu / attention: fp32 contractions in another order


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
                                   (2, 256, 512)])
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
    assert ops.launch_counts() == {"rms_norm": 0, "swiglu": 0,
                                   "flash_decode": 0}


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
    assert t_rn.plain is tref.rms_norm and t_sw.plain is tref.swiglu
    assert t_fa.plain is tref.attention


def test_ops_rejects_devices_without_a_kernel():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ConfigError, match="no kernel for device"):
        ops.rms_norm(x, torch.ones(8, device="meta"))
