"""The port's rms_norm and swiglu backward passes against the JAX package.

The JAX package has no backward kernel for either: it differentiates
`repro.kernels.ref.rms_norm` / `ref.swiglu` by autodiff.  Here the port's
plain backward versions (`repro_torch.kernels.ref.rms_norm_bwd`, and
`swiglu_bwd` from the pair `swiglu_fwd` keeps), which the card's kernels
are held to, are held against
`jax.vjp` of the JAX package's `ref` and against torch's autograd of the
port's `ref`; the autograd Functions `_RmsNorm` and `_SwiGLU` (with their
launchers replaced by the plain versions, as no card is here) against
autograd of `ref`, also where only some operands need a gradient; and the
dispatch in `kernels/ops.py` that sends a card tensor under autograd to
them, through gemma3-smoke's loss.  Inputs come from a numpy seed.

Tolerances, x max(|want|, 1), each with its reason:

* rms_norm's dx: 1e-5 (a reduction over D in another order, and the dot
  mean(dy s x) beside it);
* rms_norm's dscale: a sum over the rows, so 2 n 2^-24 of the largest
  column sum of |dy x r| over n rows (the worst case of two n-term fp32
  sums in different orders), and at least 1e-5;
* swiglu's gradients: 2e-5 (two products over D or over N in another
  order, as `tests/test_torch_cuda.py`'s products);
* gemma3-smoke's loss 1e-5 and gradients 2e-5 (`tests/test_torch_lm.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.core import flat as tflat
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import swiglu as _sw
from repro_torch.models import api as tapi
from repro_torch.models import param as tpm
from repro_torch.models import transformer as ttf
from torch_one_thread import one_torch_thread  # noqa: F401

RMS_TOL = 1e-5
PROD_TOL = 2e-5
LOSS_TOL, GRAD_TOL = 1e-5, 2e-5
U = 2.0 ** -24


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _dscale_tol(x, scale, dy, eps=1e-6):
    """2 n u max_j sum_i |dy x r|_ij: the worst case of two n-term sums."""
    d = x.shape[-1]
    x2, g2 = x.reshape(-1, d).astype(np.float64), dy.reshape(-1, d)
    r = 1.0 / np.sqrt(np.mean(x2 * x2, -1, keepdims=True) + eps)
    col = np.abs(g2 * x2 * r).sum(0)
    return max(2 * x2.shape[0] * U * float(col.max())
               / max(float(np.abs((g2 * x2 * r).sum(0)).max()), 1.0), RMS_TOL)


# ------------------------------------------------- plain vs JAX, autograd --

RMS_SHAPES = [(1, 8), (3, 98), (9, 6), (2, 5, 256), (4, 2560), (2, 5120),
              (64, 3072), (3, 3076), (2, 8192)]


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rms_norm_bwd_matches_jax_vjp_and_torch_autograd(shape):
    d = shape[-1]
    x, s, dy = _np(1, *shape), _np(2, d), _np(3, *shape)
    dx, ds = ref.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(s),
                              torch.from_numpy(dy))
    assert dx.shape == shape and ds.shape == (d,)
    _, vjp = jax.vjp(jref.rms_norm, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    tdx, tds = torch.autograd.grad(ref.rms_norm(xt, st), (xt, st),
                                   torch.from_numpy(dy))
    stol = _dscale_tol(x, s, dy)
    for want_dx, want_ds in ((jdx, jds), (tdx, tds)):
        _close(dx, want_dx, RMS_TOL)
        _close(ds, want_ds, stol)


SWIGLU_CASES = [(n, d, f) for n in (1, 8, 9, 64)
                for d, f in ((32, 64), (98, 132))]
# every pattern of (x, wg, wi) needing a gradient, but none
NEEDS = [(True, True, True), (True, False, False), (False, True, False),
         (False, False, True), (False, True, True), (True, True, False),
         (True, False, True)]


def _bwd_through_pair(x, wg, wi, dh, need=(True, True, True)):
    """The plain backward from the plain forward's pair."""
    out, p, q = ref.swiglu_fwd(x, wg, wi)
    return out, ref.swiglu_bwd(x, wg, wi, p, q, dh, need=need)


@pytest.mark.parametrize("n,d,f", SWIGLU_CASES)
def test_swiglu_bwd_matches_jax_vjp_and_torch_autograd(n, d, f):
    """The plain forward that keeps the pair (its out bitwise `ref.swiglu`)
    and the plain backward from the pair, against `jax.vjp` of the JAX
    package's `ref.swiglu` and torch's autograd of the port's."""
    x, dh = _np(4, n, d), _np(7, n, f)
    wg, wi = _np(5, d, f, scale=d ** -0.5), _np(6, d, f, scale=d ** -0.5)
    ts = [torch.from_numpy(a) for a in (x, wg, wi, dh)]
    out, got = _bwd_through_pair(*ts)
    assert torch.equal(out, ref.swiglu(*ts[:3]))
    jout, vjp = jax.vjp(jref.swiglu, jnp.asarray(x), jnp.asarray(wg),
                        jnp.asarray(wi))
    _close(out, jout, PROD_TOL)
    want_j = vjp(jnp.asarray(dh))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wi)]
    want_t = torch.autograd.grad(ref.swiglu(*ins), ins, torch.from_numpy(dh))
    for want in (want_j, want_t):
        for a, b in zip(got, want):
            _close(a, b, PROD_TOL)


def test_swiglu_bwd_skips_what_needs_no_gradient():
    x, wg, wi, dh = (torch.from_numpy(a) for a in (
        _np(1, 3, 8), _np(2, 8, 12), _np(3, 8, 12), _np(4, 3, 12)))
    _, full = _bwd_through_pair(x, wg, wi, dh)
    for need in NEEDS:
        _, got = _bwd_through_pair(x, wg, wi, dh, need=need)
        for a, b, nd in zip(got, full, need):
            assert (a is None) == (not nd)
            if nd:
                assert torch.equal(a, b)


# ---------------------------------------- the autograd Functions on the CPU --

def _plain_launchers(monkeypatch, calls):
    """The Functions' launchers replaced by the plain versions, counted."""
    def counted(name, fn):
        def call(*a, **kw):
            calls.append((name, kw.get("need")))
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(_rn, "rms_norm", counted("rms_norm", ref.rms_norm))
    monkeypatch.setattr(_rn, "rms_norm_bwd",
                        counted("rms_norm_bwd", ref.rms_norm_bwd))
    monkeypatch.setattr(_sw, "swiglu", counted("swiglu", ref.swiglu))
    monkeypatch.setattr(_sw, "swiglu_fwd",
                        counted("swiglu", ref.swiglu_fwd))
    monkeypatch.setattr(_sw, "swiglu_bwd",
                        counted("swiglu_bwd", ref.swiglu_bwd))


def _grads(fn, ins, want_grad, dout):
    ts = [torch.from_numpy(a).requires_grad_(g) for a, g in zip(ins, want_grad)]
    out = fn(*ts)
    out.backward(torch.from_numpy(dout))
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("want_grad", [(True, True), (True, False),
                                       (False, True)])
def test_rms_norm_function_matches_autograd_of_plain(monkeypatch, want_grad):
    calls = []
    _plain_launchers(monkeypatch, calls)
    ins, dy = [_np(1, 2, 7, 256), _np(2, 256)], _np(3, 2, 7, 256)
    got_out, got = _grads(_rn.rms_norm_autograd, ins, want_grad, dy)
    want_out, want = _grads(ref.rms_norm, ins, want_grad, dy)
    assert torch.equal(got_out, want_out)
    assert [c for c, _ in calls] == ["rms_norm", "rms_norm_bwd"]
    for a, b, g in zip(got, want, want_grad):
        assert (a is None) == (b is None) == (not g)
        if g:
            _close(a, b, RMS_TOL)


@pytest.mark.parametrize("want_grad", NEEDS)
def test_swiglu_function_matches_autograd_of_plain(monkeypatch, want_grad):
    calls = []
    _plain_launchers(monkeypatch, calls)
    ins = [_np(1, 2, 9, 64), _np(2, 64, 96, scale=0.125),
           _np(3, 64, 96, scale=0.125)]
    dh = _np(4, 2, 9, 96)
    got_out, got = _grads(_sw.swiglu_autograd, ins, want_grad, dh)
    want_out, want = _grads(ref.swiglu, ins, want_grad, dh)
    assert torch.equal(got_out, want_out)
    # one forward (which keeps the pair), one backward from the pair told
    # which operands need a gradient: nothing recomputes the forward
    assert calls == [("swiglu", None), ("swiglu_bwd", want_grad)]
    for a, b, g in zip(got, want, want_grad):
        assert (a is None) == (b is None) == (not g)
        if g:
            _close(a, b, PROD_TOL)


@pytest.mark.parametrize("op", ["rms_norm", "swiglu"])
@pytest.mark.parametrize("grad", [True, False])
def test_ops_sends_card_tensors_under_autograd_to_the_functions(
        monkeypatch, op, grad):
    """`ops.rms_norm` / `ops.swiglu` with the device test forced to the
    card's answer: the Function where an operand needs a gradient, the
    forward launcher alone under no_grad or where none does."""
    calls = []
    _plain_launchers(monkeypatch, calls)
    monkeypatch.setattr(ops, "_on_cuda", lambda t, name: True)
    if op == "rms_norm":
        ins = [torch.from_numpy(_np(1, 3, 16)), torch.from_numpy(_np(2, 16))]
    else:
        ins = [torch.from_numpy(_np(1, 3, 16)),
               torch.from_numpy(_np(2, 16, 8)), torch.from_numpy(_np(3, 16, 8))]
    ins[-1].requires_grad_(True)
    with torch.set_grad_enabled(grad):
        out = getattr(ops, op)(*ins)
    assert out.requires_grad == grad
    if grad:
        out.sum().backward()
        assert ins[-1].grad is not None and ins[0].grad is None
    assert [c for c, _ in calls] == [op] + ([op + "_bwd"] if grad else [])


# ------------------------------------- gemma3-smoke through the Functions --

def _gemma3_loss_and_grads(tcfg, npt, batch, remat):
    leaves, treedef = T.flatten(tpm.from_numpy_tree(npt, "cpu"))
    alias = [x.requires_grad_(True) for x in leaves]
    loss = ttf.loss_fn(tcfg, T.unflatten(treedef, alias), batch, remat=remat)
    return [loss.detach()] + list(torch.autograd.grad(loss, alias))


@pytest.mark.parametrize("remat", [False, True])
def test_gemma3_loss_grads_through_the_functions_match_plain(monkeypatch,
                                                             remat):
    """gemma3-smoke's loss and every gradient with each norm and MLP taken
    through `_RmsNorm` / `_SwiGLU` (ops' card dispatch; the launchers and
    attention plain) against autograd of the plain path; with remat the
    forward launches double (the recompute) and the backward's do not."""
    from repro.configs import registry as JR
    from repro.models import api as japi
    from repro.models import param as jpm
    jcfg, tcfg = JR.get_smoke_config("gemma3-4b"), \
        TR.get_smoke_config("gemma3-4b")
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    want = _gemma3_loss_and_grads(tcfg, npt, batch, remat)
    calls = []
    _plain_launchers(monkeypatch, calls)
    monkeypatch.setattr(ops, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(_fa, "flash_attention",
                        lambda q, k, v, **kw: ref.attention(q, k, v, **kw))
    got = _gemma3_loss_and_grads(tcfg, npt, batch, remat)
    _close(got[0], want[0], LOSS_TOL)
    for a, b in zip(got[1:], want[1:]):
        _close(a, b, GRAD_TOL)
    n = tcfg.n_layers
    fwd = 2 if remat else 1
    count = {c: sum(1 for name, _ in calls if name == c)
             for c in ("rms_norm", "rms_norm_bwd", "swiglu", "swiglu_bwd")}
    assert count == dict(rms_norm=2 * n * fwd + 1, rms_norm_bwd=2 * n + 1,
                         swiglu=n * fwd, swiglu_bwd=n)


# ------------------------------------------------ flat views stay aligned --

@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_gemma3_flat_leaves_and_layer_slices_stay_16_byte_aligned(get):
    """The kernels take 16-byte aligned operands.  Under the flat layout a
    leaf is a view at its offset in a [W, N] bucket, and each layer's
    weights a slice of its stacked leaf: every gemma3 leaf size (and layer
    slice) is a multiple of 4 floats, so every view stays aligned."""
    cfg = getattr(TR, get)("gemma3-4b")
    defs = tapi.get_module(cfg).param_defs(cfg)
    spec = tflat.FlatParamSpace(tpm.abstract_params(defs))
    assert spec.buckets == ("float32",) and spec.sizes["float32"] % 4 == 0
    w = 4
    views = spec.unflatten({"float32": torch.empty(
        w, spec.sizes["float32"], device="meta")}, lead=1)
    for lane in range(w):
        for leaf in T.leaves(views):
            assert leaf[lane].storage_offset() % 4 == 0
    for leaf in T.leaves(views["layers"]):
        for layer in range(cfg.n_layers):
            assert leaf[w - 1][layer].storage_offset() % 4 == 0
