"""The port's sync variants against the JAX package: the overlap, partial
and ring-int8 syncs of ViT Local AdamW at vit-smoke widths (16 classes,
W = 4, b_loc = 4), and the plain versions of their three kernels
(`sync_apply_update`, `ring_combine`, `ring_quantize_codes`).

Inputs come from numpy seeds; the JAX engine runs on its `jnp` backend (JAX
cannot differentiate its Pallas attention), the Pallas kernels in interpret
mode where stated.  Tolerances, each with its reason:

* plain versions against `repro.kernels.ref`: bitwise (the same IEEE ops in
  the same order, run op by op on both sides).
* against the Pallas kernels in interpret mode: `ring_quantize` bitwise;
  `sync_apply_update` and `ring_combine` within 1e-6 relative and 1 ulp of
  the operands respectively, because XLA compiles the kernel body and
  rewrites `s / 127` and `/ (k + 1)` as multiplies by a reciprocal and
  contracts multiply-adds (observed: 1 ulp of the anchor; half an ulp of
  |k * deq| + |x|).
* the split flat sync (begin / apply) against JAX's, run op by op:
  bitwise when quantized (integer codes), 1e-6 on the fp32 delta means.
* engine runs against the JAX RoundEngine, all with the int8 sync:
  per-round metrics 1e-4 relative and 2e-3 per element, as
  `tests/test_torch_train.py` states them for the unquantized run (AdamW
  turns the packages' fp32 sum-order noise into up to lr per step on an
  element whose gradient sits at that noise), that per-element bound
  times 1 + m under outer Nesterov momentum m (the outer step adds m times
  the new momentum to each delta: observed 2.4e-3 at m = 0.9), and final
  params 2e-3 relative L2 per leaf rather than 2e-4: an ulp of difference
  in a delta may round to the neighbouring int8 code, which moves the
  element by a whole level (amax / 127 of its leaf's delta), so the
  quantized runs differ from JAX's ~6x more than the unquantized one
  (observed 2.9e-4 for overlap and partial, 9.3e-4 for the ring; 4.7e-5
  unquantized).  The ring wire adds the reference's own `ring_tolerance`
  per element: the JAX engine jits its ring, so XLA's fusion may flip a
  requantized code where the port runs op by op (the reference's tests
  hold its jitted ring to the same bound).
* inside the port: overlap at depth 0 is bitwise the blocking run, the
  ring's overlap at depth 0 bitwise its blocking run, and the membership
  resize bitwise JAX's on the same state.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import RunConfig as JRun
from repro.core import engine as jeng
from repro.core import flat as jflat
from repro.core import schedules as jsched
from repro.core import sync as jsync
from repro.data.synthetic import VisionStream as JVision
from repro.kernels import ref as jref
from repro.kernels import sync_update as jsu
from repro.models import param as jpm
from repro.models import vit as jvit
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.core import flat as tflat
from repro_torch.core import schedules as tsched
from repro_torch.core import sync as tsync
from repro_torch.data.synthetic import VisionStream as TVision
from repro_torch.data.synthetic import vision_batch_fn
from repro_torch.errors import ConfigError, ShapeError
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sync_update as t_su
from repro_torch.launch import train as ttrain
from repro_torch.models import param as tpm
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

W, B_LOC, N_CLASSES = 4, 4, 16
ELEM_TOL = 1e-6
METRIC_TOL = 1e-4
PARAM_ABS_TOL = 2e-3
QUANT_REL_TOL = 2e-3
RAGGED = 262_144 + 1001      # two Pallas blocks of 256K, the second ragged

RUN = dict(schedule="qsr", optimizer="adamw", total_steps=6, peak_lr=6e-3,
           end_lr=1e-5, warmup_steps=1, h_base=2, alpha=3.5e-3,
           weight_decay=0.01, remat=False)
Q = dict(sync_quantize=True)
RING = dict(sync_quantize=True, sync_wire="ring-int8")


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------- plain versions --

@pytest.mark.parametrize("n", [5000, RAGGED])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_sync_apply_update_matches_jax_ref_and_pallas(n, quantize, momentum):
    rng = np.random.default_rng(n)
    anchor = _np(1, n)
    if quantize:     # worker-mean codes of W = 4 lanes, and their scales
        step = (rng.integers(-508, 509, n) / 4).astype(np.float32)
        scale = (np.abs(_np(2, n)) * 1e-3 + 1e-4).astype(np.float32)
    else:
        step, scale = _np(3, n, scale=1e-3), None
    mu = _np(4, n, scale=1e-3) if momentum else None
    got = tref.sync_apply_update(_t(step), _t(anchor), scale=_t(scale),
                                 mu=_t(mu), momentum=momentum)
    kw = dict(scale=_j(scale), mu=_j(mu), momentum=momentum)
    want = jref.sync_apply_update(_j(step), _j(anchor), **kw)
    pallas = jsu.sync_apply_update(_j(step), _j(anchor), interpret=True, **kw)
    for g, r, p in zip(got, want, pallas):
        if r is None:
            assert g is None and p is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=ELEM_TOL,
                                   atol=ELEM_TOL)


@pytest.mark.parametrize("n", [1000, RAGGED])
def test_ring_kernels_match_jax_ref_and_pallas(n):
    acc, x = _np(5, n, scale=1e-3), _np(6, n, scale=1e-3)
    s = np.float32(np.abs(acc).max())
    q = tref.ring_quantize_codes(_t(acc), torch.tensor(s))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jref.ring_quantize_codes(_j(acc), s)))
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jsu.ring_quantize(_j(acc), s, interpret=True)))
    for k in (1, 2, 3):
        acc_t, am_t = tref.ring_combine(q, torch.tensor(s), _t(x), k)
        acc_r, am_r = jref.ring_combine(_j(q.numpy()), s, _j(x), k)
        np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_r))
        assert float(am_t) == float(am_r) == float(acc_t.abs().max())
        acc_p, am_p = jsu.ring_combine(_j(q.numpy()), s, _j(x), k,
                                       interpret=True)
        deq = q.numpy().astype(np.float32) * (s / np.float32(127))
        ulp = np.spacing(np.abs(np.float32(k) * deq) + np.abs(x))
        diff = np.abs(acc_t.numpy() - np.asarray(acc_p))
        assert (diff <= ulp).all(), float((diff / ulp).max())
        assert abs(float(am_t) - float(am_p)) <= diff.max()


def test_ops_sends_cpu_ring_and_apply_calls_to_the_plain_versions():
    ops.reset_launch_counts()
    acc, s = _t(_np(7, 33)), torch.tensor(0.5)
    q = ops.ring_quantize_codes(acc, s)
    assert torch.equal(q, tref.ring_quantize_codes(acc, s))
    for a, b in zip(ops.ring_combine(q, s, acc, 2),
                    tref.ring_combine(q, s, acc, 2)):
        assert torch.equal(a, b)
    step, anchor, mu = _t(_np(8, 33)), _t(_np(9, 33)), _t(_np(10, 33))
    got = ops.sync_apply_update(step, anchor, scale=anchor.abs(), mu=mu,
                                momentum=0.9)
    want = tref.sync_apply_update(step, anchor, scale=anchor.abs(), mu=mu,
                                  momentum=0.9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0] is not anchor and got[1] is not mu
    counts = ops.launch_counts()
    assert {"sync_apply_update", "ring_combine", "ring_quantize"} <= set(counts)
    assert set(counts.values()) == {0}


def test_new_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_su.sync_apply_update(x, x)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_su.ring_combine(torch.zeros(8, dtype=torch.int8), torch.tensor(1.0),
                          x, 1)
    with pytest.raises(ShapeError, match="CUDA kernel"):
        t_su.ring_quantize(x, torch.tensor(1.0))
    assert t_su.plain_apply is tref.sync_apply_update
    assert t_su.plain_ring_combine is tref.ring_combine
    assert t_su.plain_ring_quantize is tref.ring_quantize_codes


# ------------------------------------------------------------ ring host --

@pytest.mark.parametrize("w,n", [(2, 1001), (3, 1001), (4, 1001), (4, 4096)])
def test_ring_codes_host_matches_jax_bitwise(w, n):
    d = _np(w * n, w, n, scale=1e-3)
    q, s = tsync.ring_codes_host(_t(d))
    jq, js = jsync.ring_codes_host(_j(d))
    assert q.shape == (w, -(-n // w)) and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the ring mean lies within the reference's bound of the exact mean
    mean = q.reshape(-1)[:n].float() * s.repeat_interleave(q.shape[1])[:n] \
        / 127.0
    err = float((mean - _t(d).mean(0)).abs().max())
    assert err <= tsync.ring_tolerance(w, float(np.abs(d).max()))
    assert tsync.ring_tolerance(w, 0.5, 3) == jsync.ring_tolerance(w, 0.5, 3)


# -------------------------------------------------- flat begin / apply --

def _flat_tree(seed):
    """A small params tree of 3 leaves (per-tensor scales differ)."""
    return {"a": _np(seed, 3, 5), "b": {"c": _np(seed + 1, 7, scale=3.0)},
            "d": _np(seed + 2, 11, scale=0.1)}


@pytest.mark.parametrize("entry", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (False, 0.9), (True, 0.9)])
def test_flat_begin_apply_match_jax(quantize, momentum, masked, entry):
    single = _flat_tree(20)
    jspec = jflat.FlatParamSpace(jax.tree.map(jnp.asarray, single))
    tspec = tflat.FlatParamSpace(tpm.from_numpy_tree(single, "cpu"))
    n = tspec.sizes["float32"]
    state = {"params": {"float32": _np(21, W, n, scale=1e-2)
                        + jspec.flatten(single)["float32"][None]}}
    state["anchor"] = {"float32": np.asarray(jspec.flatten(single)["float32"])}
    if momentum:
        state["outer_mu"] = {"float32": _np(22, n, scale=1e-3)}
    mask = np.array([1, 1, 0, 1], np.float32) if masked else None
    entry_p = ({"float32": state["params"]["float32"] - _np(23, W, n, scale=1e-3)}
               if entry else None)
    kw = dict(sync_quantize=quantize, outer_momentum=momentum)
    jrun, trun = JRun(**kw), TRun(**kw)

    def port(x):
        return T.map(lambda a: torch.from_numpy(np.array(a)), x)

    jb = jsync.make_sync_begin(jrun, jspec, partial=masked)
    tb = tsync.make_sync_begin(trun, tspec, partial=masked)
    jstate = jax.tree.map(jnp.asarray, state)
    jpend = jb(jstate, _j(mask)) if masked else jb(jstate)
    tpend = tb(port(state), _t(mask)) if masked else tb(port(state))
    jout = jsync.make_sync_apply(jrun, jspec)(
        jstate, jpend, None if entry_p is None else jax.tree.map(
            jnp.asarray, entry_p))
    tst = port(state)
    tout = tsync.make_sync_apply(trun, tspec)(
        tst, tpend, None if entry_p is None else port(entry_p))
    for x, y in ((tpend, jpend), (tout, jout)):
        lt, lj = T.leaves(x), jax.tree.leaves(y)
        assert len(lt) == len(lj)
        for a, b in zip(lt, lj):
            if quantize:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=ELEM_TOL, atol=ELEM_TOL)
    # the apply wrote new tensors: the input state is as it was
    for a, b in zip(T.leaves(tst), T.leaves(port(state))):
        assert torch.equal(a, b)


# ---------------------------------------------------- engine vs engine --

def _cfgs():
    return (dataclasses.replace(JR.get_smoke_config("vit-b16"),
                                n_classes=N_CLASSES),
            dataclasses.replace(TR.get_smoke_config("vit-b16"),
                                n_classes=N_CLASSES))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    jp = jpm.init_params(jvit.param_defs(jcfg), jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _jax_batch_fn(w=W):
    stream = JVision(n_classes=N_CLASSES, seed=42)

    def fn(step):
        xs, ys = zip(*[stream.batch(step, i, B_LOC) for i in range(w)])
        return {"images": jnp.stack(xs), "labels": jnp.stack(ys)}
    return fn


def _drive(eng, state, run, lr_fn, get_h):
    """Every round of the run; returns the flushed state and the per-round
    metrics as floats."""
    t, metrics = 0, []
    while t < run.total_steps:
        state, m = eng.run_round(state, t, get_h(run, t, lr_fn), lr_fn)
        metrics.append({k: float(v) for k, v in m.items()})
        t = eng.h_trace[-1][0] + eng.h_trace[-1][1]
    return eng.flush(state), metrics


def _jax_engine(jp, sync, depth=0, mask=None, **kw):
    jcfg, _ = _cfgs()
    run = JRun(**dict(RUN, **kw))
    eng = jeng.RoundEngine(jcfg, run, workers=W, b_loc=B_LOC, seq=1,
                           data="host", layout="flat", sync=sync,
                           overlap_depth=depth, batch_fn=_jax_batch_fn())
    state = eng.init_state(jp)
    if mask is not None:
        eng.membership_epoch(mask)
    state, metrics = _drive(eng, state, run, jlr.make_lr_fn(run),
                            jsched.get_h)
    return eng, jax.tree.map(np.asarray, eng.params_single(state)), metrics


def _port_eng(npt, sync="blocking", depth=0, mask=None, layout="flat",
              **kw):
    """(engine, initial state) of the port on the CPU."""
    _, tcfg = _cfgs()
    eng = teng.RoundEngine(tcfg, TRun(**dict(RUN, **kw)), workers=W,
                           b_loc=B_LOC, seq=1, data="host", layout=layout,
                           sync=sync, overlap_depth=depth, device="cpu",
                           batch_fn=vision_batch_fn(
                               TVision(n_classes=N_CLASSES, seed=42), W,
                               B_LOC))
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    if mask is not None:
        eng.membership_epoch(mask)
    return eng, state


def _port_engine(npt, sync="blocking", depth=0, mask=None, layout="flat",
                 **kw):
    eng, state = _port_eng(npt, sync, depth, mask, layout, **kw)
    run = eng.run_cfg
    return (eng,) + _drive(eng, state, run, tlr.make_lr_fn(run),
                           tsched.get_h)


ENGINE_CASES = [("overlap-d0", "overlap", 0, None, Q),
                ("overlap-d1-momentum", "overlap", 1, None,
                 dict(Q, outer_momentum=0.9)),
                ("partial-1101", "partial", 0, [1, 1, 0, 1], Q),
                ("ring-blocking", "blocking", 0, None, RING),
                ("ring-overlap-d0", "overlap", 0, None, RING)]


@pytest.mark.parametrize("case", ENGINE_CASES, ids=[c[0] for c in ENGINE_CASES])
def test_engine_sync_variants_match_jax_engine(params, case):
    _, sync, depth, mask, kw = case
    jeng_, j_final, j_metrics = _jax_engine(params[0], sync, depth, mask,
                                            **kw)
    teng_, t_state, t_metrics = _port_engine(params[1], sync, depth, mask,
                                             **kw)
    assert teng_.h_trace == jeng_.h_trace and len(teng_.h_trace) == 3
    for a, b in zip(j_metrics, t_metrics):   # divergence: before the sync
        for k in ("loss", "grad_norm", "divergence"):
            assert abs(a[k] - b[k]) <= METRIC_TOL * abs(a[k]), (k, a, b)
    ring = kw.get("sync_wire") == "ring-int8"
    abs_tol = PARAM_ABS_TOL * (1.0 + kw.get("outer_momentum", 0.0))
    if ring:
        abs_tol += tsync.ring_tolerance(W, 4.0 * 2 * RUN["peak_lr"], 3)
    got = T.leaves(teng_.params_single(t_state))
    for a, b in zip(jax.tree.leaves(j_final), got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= QUANT_REL_TOL * np.linalg.norm(a)
        assert np.abs(a - b).max() <= abs_tol
    if sync == "partial":
        assert [(e.workers, e.membership, e.resized) for e in teng_.epochs] \
            == [(e.workers, e.membership, e.resized) for e in jeng_.epochs]


@pytest.mark.parametrize("layout,momentum", [("flat", 0.0), ("flat", 0.9),
                                             ("tree", 0.9)])
def test_overlap_depth0_is_bitwise_the_blocking_run(params, layout, momentum):
    kw = dict(Q, outer_momentum=momentum)
    _, blk, _ = _port_engine(params[1], layout=layout, **kw)
    _, ovl, _ = _port_engine(params[1], "overlap", 0, layout=layout, **kw)
    lb, tdb = T.flatten(blk)
    lo, tdo = T.flatten(ovl)
    assert tdb == tdo
    assert all(torch.equal(a, b) for a, b in zip(lb, lo))


def test_ring_overlap_depth0_is_bitwise_the_ring_blocking_run(params):
    """The port runs its ring op by op, so the begin/apply split moves no
    code (the JAX engine's jitted split may)."""
    _, blk, _ = _port_engine(params[1], **RING)
    _, ovl, _ = _port_engine(params[1], "overlap", 0, **RING)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(blk),
                                                 T.leaves(ovl)))
    _, exact, _ = _port_engine(params[1], **Q)
    worst = max(float((a - b).abs().max()) for a, b in
                zip(T.leaves(blk["params"]), T.leaves(exact["params"])))
    assert 0.0 < worst <= tsync.ring_tolerance(W, 4.0 * 2 * RUN["peak_lr"],
                                               3) + PARAM_ABS_TOL


def test_partial_sync_reanchors_every_lane(params):
    eng, st = _port_eng(params[1], "partial", mask=[1, 1, 0, 1], **Q)
    run = eng.run_cfg
    st, _ = eng.run_round(st, 0, 2, lambda t: 1e-3)
    b = eng.spec.buckets[0]
    assert torch.equal(st["params"][b],
                       st["anchor"][b][None].expand_as(st["params"][b]))
    # an all-ones mask is bitwise the blocking sync (W a power of two)
    sync_p = tsync.make_sync_partial(run, eng.spec)
    sync_b = tsync.make_sync(run, spec=eng.spec)
    pert = {**st, "params": {b: st["params"][b]
                             + _t(_np(30, W, st["params"][b].shape[1],
                                     scale=1e-3))}}
    a = sync_p(pert, torch.ones(W))
    c = sync_b({**pert, "params": {b: pert["params"][b].clone()},
                "anchor": {b: pert["anchor"][b].clone()}})
    assert all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(c)))


def test_synced_view_is_pure_and_flush_equals_it(params):
    eng, st = _port_eng(params[1], "overlap", 1, **Q, outer_momentum=0.9)
    st, _ = eng.run_round(st, 0, 2, lambda t: 1e-3)
    assert eng._pending is not None
    before = [x.clone() for x in T.leaves(st)]
    v1, v2 = eng.synced_view(st), eng.synced_view(st)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(st), before))
    with pytest.raises(teng.PendingSyncError):
        eng.params_single(st)
    fl = eng.flush(st)
    assert eng._pending is None
    for a, b, c in zip(T.leaves(v1), T.leaves(v2), T.leaves(fl)):
        assert torch.equal(a, b) and torch.equal(a, c)
    eng.set_overlap_depth(0)
    assert eng.overlap_depth == 0
    with pytest.raises(teng.MembershipError, match=">= 0"):
        eng.set_overlap_depth(-1)


def test_membership_resize_matches_jax(params):
    """Shrink to lanes (0, 1, 3), then grow back to 4, on the same flat state
    in both packages: every buffer bitwise, the epochs equal."""
    jcfg, tcfg = _cfgs()
    run_kw = dict(RUN, **Q, outer_momentum=0.9)
    je = jeng.RoundEngine(jcfg, JRun(**run_kw), workers=W, b_loc=B_LOC,
                          seq=1, data="host", layout="flat", sync="partial",
                          batch_fn=_jax_batch_fn())
    js = je.init_state(params[0])
    je.membership_epoch([1, 1, 0, 1])
    js, _ = je.run_round(js, 0, 2, lambda t: 1e-3)
    te = teng.RoundEngine(tcfg, TRun(**run_kw), workers=W, b_loc=B_LOC,
                          seq=1, data="host", layout="flat", sync="partial",
                          device="cpu", batch_fn=vision_batch_fn(
                              TVision(n_classes=N_CLASSES, seed=42), W,
                              B_LOC))
    te.init_state(tpm.from_numpy_tree(params[1], "cpu"))
    te.membership_epoch([1, 1, 0, 1])
    ts = T.map(lambda x: torch.from_numpy(np.array(x)), js)
    for kw in (dict(keep_lanes=(0, 1, 3)), dict(grow_to=4)):
        js = je.membership_epoch(state=js, **kw)
        ts = te.membership_epoch(state=ts, **kw)
        assert te.workers == je.workers
        lj, lt = jax.tree.leaves(js), T.leaves(ts)
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert [(e.index, e.workers, e.membership, e.resized)
            for e in te.epochs] == [(e.index, e.workers, e.membership,
                                     e.resized) for e in je.epochs]
    assert te.workers == W and list(te.membership) == [1.0] * W
    ts, m = te.run_round(ts, 2, 2, lambda t: 1e-3)
    assert np.isfinite(float(m["loss"]))


def test_train_runs_each_sync_variant_and_returns_the_flushed_state():
    _, tcfg = _cfgs()
    fn = vision_batch_fn(TVision(n_classes=N_CLASSES, seed=42), 2, 2)
    for sync, kw in (("overlap", Q), ("partial", Q), ("blocking", RING)):
        run = TRun(**dict(RUN, **kw))
        eng = teng.RoundEngine(tcfg, run, workers=2, b_loc=2, seq=1,
                               data="host", layout="flat", sync=sync,
                               overlap_depth=1, batch_fn=fn, device="cpu")
        seen = []

        def eval_fn(t, state):
            seen.append(t)
            p = state["params"]["float32"]
            assert torch.equal(p[0], p[1])      # every view is synced

        state, hist = ttrain.train(tcfg, run, workers=2, b_loc=2, seq=1,
                                   data="host", layout="flat", sync=sync,
                                   overlap_depth=1, eng=eng,
                                   eval_fn=eval_fn, log_every=0)
        assert seen == [t for t, _, _, _ in hist] and len(hist) == 3
        assert eng._pending is None
        p = state["params"]["float32"]
        assert torch.equal(p[0], p[1])


# ------------------------------------------------------------- guards --

def test_guards_raise_as_in_jax():
    spec_t = tflat.FlatParamSpace(tpm.from_numpy_tree(_flat_tree(1), "cpu"))
    spec_j = jflat.FlatParamSpace(jax.tree.map(jnp.asarray, _flat_tree(1)))
    for make_t, make_j, run, spec, match in (
            (tsync.make_sync_partial, jsync.make_sync_partial, RING, True,
             "does not compose with partial"),
            (tsync.make_sync, jsync.make_sync, RING, False,
             "needs a flat layout"),
            (tsync.make_sync, jsync.make_sync,
             dict(sync_wire="ring-int8"), True, "requires sync_quantize"),
            (tsync.make_sync, jsync.make_sync,
             dict(sync_quantize=True, sync_wire="ring-int4"), True,
             "unknown sync_wire")):
        with pytest.raises(ValueError, match=match):
            make_j(JRun(**run), spec_j if spec else None)
        with pytest.raises(ValueError, match=match):
            make_t(TRun(**run), spec_t if spec else None)
    assert tsync.WIRE_MODES == jsync.WIRE_MODES
    assert tsync.SYNC_PROGRAMS == jsync.SYNC_PROGRAMS
    with pytest.raises(ConfigError, match="unknown sync program"):
        tsync.sync_program(TRun(), program="gather")
    # the collective halves are ported (tests/test_torch_mesh*.py): on a
    # mesh-carrying spec the ring refuses a mask as the reference's does
    with pytest.raises(ValueError, match="does not compose with partial"):
        tsync.make_sync_begin(
            TRun(**RING), types.SimpleNamespace(mesh=object(),
                                                worker_axes=("data",)),
            partial=True)

    _, tcfg = _cfgs()
    fn = vision_batch_fn(TVision(n_classes=N_CLASSES), 2, 2)
    base = dict(workers=2, b_loc=2, seq=1, data="host", batch_fn=fn,
                device="cpu", layout="flat")
    eng = teng.RoundEngine(tcfg, TRun(**dict(RUN, **Q)), sync="overlap",
                           **base)
    st = eng.init_state()
    st, _ = eng.run_round(st, 0, 1, lambda t: 1e-3)
    with pytest.raises(teng.MembershipError, match="in flight"):
        eng.membership_epoch([1, 0])
    st = eng.flush(st)
    for mask in ([0, 0], [1, 1, 1]):
        with pytest.raises(teng.MembershipError, match="at least one"):
            eng.membership_epoch(mask)
    with pytest.raises(teng.MembershipError, match="does not grow"):
        eng.membership_epoch(state=st, grow_to=2)
    with pytest.raises(teng.MembershipError, match="only a knob"):
        teng.RoundEngine(tcfg, TRun(**RUN), **base).set_overlap_depth(1)
    with pytest.raises(ConfigError, match="bucketed"):
        teng.RoundEngine(tcfg, TRun(**RUN), sync="partial", mode="legacy",
                         **base)
    ring_partial = teng.RoundEngine(tcfg, TRun(**dict(RUN, **RING)),
                                    sync="partial", **base)
    with pytest.raises(ValueError, match="does not compose with partial"):
        ring_partial.run_round(ring_partial.init_state(), 0, 1,
                               lambda t: 1e-3)
