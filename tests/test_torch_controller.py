"""The port's adaptive controller against the JAX package: the decision
stream (`core/controller.py`), the effective-batch view and its
`batch_epoch`, replayed adaptive runs of the RoundEngine, the microbatched
local step, and the training CLI's adaptive flags.

The controller's H is `int(prior * corr)` with `corr` from EMAs of the
measured divergence, so a divergence that differs in its last bits can
move H by a step and two free-running runs part.  The layer is held in two
parts instead:

* decisions: both controllers are fed the same telemetry (float32 values,
  as 0-d tensors on each side, read with `float()` as the engine's are) and
  their `json.dumps(trace_record(), sort_keys=True)` must be equal, and so
  must the calls they make on their stub engines;
* arithmetic: the port's engine replays the reference run's (h, lanes,
  depth) sequence, and its per-round metrics and final params are held to
  the reference's.

Tolerances, each with its reason:

* decisions, traces, frontiers, batch views, epochs: equal (pure Python,
  or a gather: no arithmetic).
* the replayed runs, 24 steps from the reference's params (starcoder2-3b
  smoke, W = 2, b_loc = 4, seq 16, host data; ViT-smoke on the flat
  layout with overlap and a frontier): per-round loss, grad norm and
  divergence within 1e-5 relative, each leaf of the final params within
  2e-5 relative L2: fp32 sums in another order (observed 5.8e-7 and 9.7e-6
  on starcoder2, 3.3e-7 and 4.1e-6 on ViT).
* the microbatched local step against the reference's `make_local_step`:
  loss within 1e-6 relative, each gradient element (AdamW's first moment
  over 1 - beta1) within 2e-5 relative and absolute.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import RunConfig as JRun
from repro.core import controller as jctl
from repro.core import engine as jeng
from repro.core import local_update as JLU
from repro.core import schedules as jsched
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import param as jpm
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import controller as tctl
from repro_torch.core import engine as teng
from repro_torch.core import local_update as TLU
from repro_torch.core import schedules as tsched
from repro_torch.data import synthetic as tsyn
from repro_torch.errors import ConfigError
from repro_torch.launch import train as ttrain
from repro_torch.models import param as tpm
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

METRIC_TOL, PARAM_TOL = 1e-5, 2e-5
LOSS_TOL, GRAD_TOL = 1e-6, 2e-5
W, B_LOC, SEQ = 2, 4, 16
N_CLASSES = 16


@pytest.fixture(autouse=True)
def reference_dispatch_at_defaults():
    """The reference's MoE dispatch globals (set by its `make_loss`) at
    their defaults before and after every test."""
    jmoe.set_dispatch_shards(1)
    jmoe.set_dispatch("auto", None)
    try:
        yield
    finally:
        jmoe.set_dispatch_shards(1)
        jmoe.set_dispatch("auto", None)


def _run_kw(**kw):
    """The reference controller tests' run config."""
    base = dict(schedule="adaptive", optimizer="adamw", total_steps=24,
                peak_lr=3e-3, end_lr=1e-6, warmup_steps=2, h_base=2,
                alpha=0.001, remat=False, weight_decay=0.01)
    base.update(kw)
    return base


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


def _trace_json(ctrl):
    return json.dumps(ctrl.trace_record(), sort_keys=True)


# ------------------------------------------------------------ decisions --

class _StubEngine:
    """The attributes and methods the controller drives, and its calls."""

    def __init__(self, b_loc=8, sync_mode="blocking", adaptive_batch=True):
        self.b_loc, self.sync_mode = b_loc, sync_mode
        self.adaptive_batch = adaptive_batch
        self.batch_lanes = b_loc
        self.overlap_depth = 0
        self.calls = []

    def batch_epoch(self, lanes):
        self.calls.append(("batch", lanes))
        self.batch_lanes = lanes

    def set_overlap_depth(self, depth):
        self.calls.append(("depth", depth))
        self.overlap_depth = depth


def _steady(scale=1.0, late=None, mid=None):
    """Telemetry with drift intensity kappa following the SDE scaling
    kappa * eta * sqrt(h) (the reference tests' `_flat_metrics`), scaled by
    `late` after step `mid`."""
    def metrics(t, h, eta):
        s = scale if late is None or t <= mid else late
        return {"loss": 5.0 - 0.01 * t, "grad_norm": 1.0,
                "divergence": s * 0.01 * eta * np.sqrt(h)}
    return metrics


def _plateau(t, h, eta):
    """The reference's batch-ratchet telemetry: the loss flattens after
    step 250."""
    return {"loss": 5.0 - min(0.002 * t, 0.5), "grad_norm": 1.0,
            "divergence": 0.01 * np.sqrt(h)}


# (run config, stub engine or None, frontier, telemetry): the reference
# tests' scenarios (tests/test_controller.py)
SCENARIOS = {
    "warmup-pin": (dict(total_steps=400, warmup_steps=80, h_base=3), None,
                   None, _steady()),
    "divergence-hot": (dict(total_steps=4000, warmup_steps=100, h_base=1,
                            alpha=0.05), None, None,
                       _steady(late=8.0, mid=2000)),
    "divergence-cool": (dict(total_steps=4000, warmup_steps=100, h_base=1,
                             alpha=0.05), None, None,
                        _steady(late=1 / 8.0, mid=2000)),
    "batch-ratchet": (dict(total_steps=3000, warmup_steps=100, alpha=0.02),
                      dict(b_loc=8), None, _plateau),
    "depth-frontier": (dict(total_steps=3000, warmup_steps=100, alpha=0.02),
                       dict(sync_mode="overlap", adaptive_batch=False),
                       {0: 1.0, 1: 0.6, 2: 0.5},
                       _steady(late=8.0, mid=1500)),
    "truncation": (dict(total_steps=37, warmup_steps=3, alpha=0.01), None,
                   None, _steady()),
}


def _drive_both(run_kw, stub, frontier, telemetry):
    """Both controllers over a whole run on the same float32 telemetry:
    0-d jax arrays for the reference, 0-d torch tensors for the port."""
    jrun, trun = JRun(**_run_kw(**run_kw)), TRun(**_run_kw(**run_kw))
    jlr_fn, tlr_fn = jlr.make_lr_fn(jrun), tlr.make_lr_fn(trun)
    engines = ((_StubEngine(**stub), _StubEngine(**stub)) if stub is not None
               else (None, None))
    jc = jctl.AdaptiveController(jrun, jlr_fn, engine=engines[0],
                                 frontier=frontier)
    tc = tctl.AdaptiveController(trun, tlr_fn, engine=engines[1],
                                 frontier=frontier)
    t = 0
    while t < jrun.total_steps:
        h = jc.begin_round(t)
        assert tc.begin_round(t) == h
        eta = jlr_fn(max(t, jrun.warmup_steps))
        m = {k: np.float32(v) for k, v in telemetry(t, h, eta).items()}
        jc.end_round(t, h, {k: jnp.asarray(v) for k, v in m.items()})
        tc.end_round(t, h, {k: torch.tensor(v) for k, v in m.items()})
        t += h
    return jc, tc, engines


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decisions_equal_the_reference_on_the_same_telemetry(name):
    run_kw, stub, frontier, telemetry = SCENARIOS[name]
    jc, tc, (je, te) = _drive_both(run_kw, stub, frontier, telemetry)
    assert _trace_json(tc) == _trace_json(jc)
    rec = tc.trace_record()
    assert rec["schema"] == tctl.TRACE_SCHEMA == jctl.TRACE_SCHEMA
    assert rec["summary"]["steps"] == run_kw["total_steps"]
    rows = rec["rounds"]
    if je is not None:
        assert te.calls == je.calls
    # each scenario reaches what it is named for
    if name == "warmup-pin":
        assert all(r["h_correction"] == 1.0 for r in rows
                   if r["t"] < run_kw["warmup_steps"])
        assert "warmup-pin" in rows[0]["reasons"]
    elif name == "divergence-hot":
        assert any(r["h_correction"] < 1.0 for r in rows if r["t"] > 2000)
    elif name == "divergence-cool":
        assert any(r["h_correction"] > 1.0 for r in rows if r["t"] > 2000)
    elif name == "batch-ratchet":
        lanes = [r["batch_lanes"] for r in rows]
        assert lanes == sorted(lanes) and lanes[0] == 4 and lanes[-1] == 8
        assert ("batch", 8) in te.calls
    elif name == "depth-frontier":
        assert ("depth", 2) in te.calls
        assert any(r["overlap_depth"] == 0 for r in rows if r["t"] > 1500)
    else:
        # the last round ends at the horizon, shorter than the rule's H
        last = rows[-1]
        assert last["t"] + last["h"] == run_kw["total_steps"]
        assert last["h"] < int((0.01 / last["lr"]) ** 2)


def test_controller_refusals_match_the_reference():
    run = TRun(**_run_kw(schedule="qsr"))
    with pytest.raises(ValueError, match="drives schedule='adaptive'"):
        tctl.AdaptiveController(run, tlr.make_lr_fn(run))
    run = TRun(**_run_kw())
    ctrl = tctl.AdaptiveController(run, tlr.make_lr_fn(run))
    with pytest.raises(RuntimeError, match="without a matching begin_round"):
        ctrl.end_round(0, 2, {"loss": 1.0, "divergence": 0.1})
    ctrl.begin_round(0)
    with pytest.raises(RuntimeError, match="round-boundary-only"):
        ctrl.begin_round(0)
    assert dataclasses.asdict(tctl.ControllerConfig()) == \
        dataclasses.asdict(jctl.ControllerConfig())
    for b in (1, 6, 8, 12, 32):
        for target in range(1, 40):
            assert tctl._pow2_divisor_at_most(b, target) == \
                jctl._pow2_divisor_at_most(b, target)


# ------------------------------------------------------------- frontier --

TABLE4 = {"overlap": {"blocking_d0": {"s_per_round": 2.8},
                      "overlap_d1": {"s_per_round": 2.1},
                      "overlap_d1_ring": {"s_per_round": 9.9},
                      "notes": {"s_per_round": "n/a"}}}


@pytest.mark.parametrize("form", ["table4", "table4-path", "plain",
                                  "missing-path"])
def test_load_frontier_equals_the_reference(form, tmp_path):
    arg = {"table4": TABLE4, "plain": {"0": 1.0, "2": 0.5},
           "missing-path": str(tmp_path / "none.json")}.get(form)
    if form == "table4-path":
        arg = str(tmp_path / "table4.json")
        with open(arg, "w") as f:
            json.dump(TABLE4, f)
    got = tctl.load_frontier(arg)
    assert got == jctl.load_frontier(arg)
    assert got == {"table4": {0: 2.8, 1: 2.1}, "table4-path": {0: 2.8, 1: 2.1},
                   "plain": {0: 1.0, 2: 0.5}, "missing-path": None}[form]


# ------------------------------------------------------- batch view -------

@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_effective_batch_view_is_bitwise_the_reference(lanes):
    rng = np.random.default_rng(lanes)
    batch = {"tokens": rng.integers(0, 97, (W, B_LOC, 8)).astype(np.int32),
             "images": rng.standard_normal((W, B_LOC, 3, 5)).astype(
                 np.float32),
             "lane_ids": np.arange(W, dtype=np.int32)}
    want = jsyn.effective_batch_view(
        {k: jnp.asarray(v) for k, v in batch.items()}, lanes, axis=1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tsyn.effective_batch_view(tb, lanes, axis=1)
    for k in batch:
        assert got[k].dtype == tb[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["lane_ids"] is tb["lane_ids"]       # ndim <= axis: passed
    if lanes == B_LOC:
        assert all(torch.equal(got[k], tb[k]) for k in batch)
    else:
        assert torch.equal(got["tokens"][:, lanes:2 * lanes],
                           tb["tokens"][:, :lanes])


# ------------------------------------------------------ engine knobs ------

def _lm_engine(run, **kw):
    return teng.RoundEngine(TR.get_smoke_config("starcoder2-3b"), run,
                            workers=W, b_loc=B_LOC, seq=SEQ, data="host",
                            device="cpu", **kw)


def test_batch_epoch_validation():
    run = TRun(**_run_kw())
    eng = _lm_engine(run, adaptive_batch=True)
    assert eng.batch_lanes == B_LOC and eng.batch_epochs == []
    for bad in (0, 3, 5, 8):
        with pytest.raises(teng.MembershipError, match="must divide"):
            eng.batch_epoch(bad)
    eng.batch_epoch(2)
    assert eng.batch_epochs == [teng.BatchEpoch(index=0, lanes=2, b_loc=4,
                                                round_index=0)]
    plain = _lm_engine(run)
    with pytest.raises(teng.MembershipError, match="adaptive_batch=True"):
        plain.batch_epoch(2)
    with pytest.raises(teng.MembershipError, match="only a knob"):
        plain.set_overlap_depth(1)
    with pytest.raises(ConfigError, match="needs mode='bucketed'"):
        _lm_engine(run, adaptive_batch=True, mode="legacy")


def test_full_lane_adaptive_engine_is_bitwise_the_plain_engine():
    """lanes == b_loc: the view is the identity, the run the plain one."""
    run = TRun(**_run_kw(schedule="qsr", total_steps=8))
    lr_fn = tlr.make_lr_fn(run)
    ea, ep = _lm_engine(run, adaptive_batch=True), _lm_engine(run)
    sa, sp = ea.init_state(), ep.init_state()
    for t, h in tsched.rounds(run, lr_fn):
        sa, _ = ea.run_round(sa, t, h, lr_fn)
        sp, _ = ep.run_round(sp, t, h, lr_fn)
    la, lp = T.leaves(sa), T.leaves(sp)
    assert len(la) == len(lp)
    assert all(torch.equal(a, b) for a, b in zip(la, lp))


# ---------------------------------------------------------- replayed runs --

def _reference_adaptive_run(jcfg, jp, run, *, batch_fn=None, layout="tree",
                            sync="blocking", frontier=None):
    """The JAX package's adaptive run: its controller around its engine.
    Returns (controller, engine, per-round metrics as floats, final
    params as numpy)."""
    eng = jeng.RoundEngine(jcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", batch_fn=batch_fn, layout=layout,
                           sync=sync, adaptive_batch=True)
    lr_fn = jlr.make_lr_fn(run)
    ctrl = jctl.AdaptiveController(run, lr_fn, engine=eng, frontier=frontier)
    state, t, metrics = eng.init_state(jp), 0, []
    while t < run.total_steps:
        h = ctrl.begin_round(t)
        state, m = eng.run_round(state, t, h, lr_fn)
        ctrl.end_round(t, h, m)
        metrics.append({k: float(v) for k, v in m.items()})
        t += h
    state = eng.flush(state)
    return ctrl, eng, metrics, jax.tree.map(np.asarray,
                                            eng.params_single(state))


def _replay(tcfg, npt, run, rows, **eng_kw):
    """The port's engine through the reference run's (h, lanes, depth)
    sequence, from the reference's params."""
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", device="cpu", adaptive_batch=True,
                           **eng_kw)
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    lr_fn = tlr.make_lr_fn(run)
    for r in rows:
        if eng.batch_lanes != r["batch_lanes"]:
            eng.batch_epoch(r["batch_lanes"])
        if eng.sync_mode == "overlap" and \
                eng.overlap_depth != r["overlap_depth"]:
            eng.set_overlap_depth(r["overlap_depth"])
        state, _ = eng.run_round(state, r["t"], r["h"], lr_fn)
    return eng, eng.flush(state)


def _hold_replay(jc, je, j_metrics, j_final, eng, state):
    rows = jc.trace
    assert eng.h_trace == je.h_trace == [(r["t"], r["h"]) for r in rows]
    assert [dataclasses.asdict(e) for e in eng.batch_epochs] == \
        [dataclasses.asdict(e) for e in je.batch_epochs]
    for jm, tm in zip(j_metrics, eng.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert _rel(jm[k], float(tm[k])) <= METRIC_TOL, (k, jm, tm)
    got = T.leaves(eng.params_single(state))
    want = jax.tree.leaves(j_final)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= PARAM_TOL * np.linalg.norm(a)
    # the port's controller fed the reference run's telemetry, round by
    # round, rebuilds the reference's trace byte for byte (a stub engine
    # in place of the engine: the decisions, not the arithmetic)
    stub = _StubEngine(b_loc=B_LOC, sync_mode=je.sync_mode)
    ctrl = tctl.AdaptiveController(TRun(**dataclasses.asdict(je.run_cfg)),
                                   tlr.make_lr_fn(je.run_cfg), engine=stub,
                                   frontier=jc.frontier)
    for r in rows:
        assert ctrl.begin_round(r["t"]) == r["h"]
        ctrl.end_round(r["t"], r["h"], r["measured"])
    assert _trace_json(ctrl) == _trace_json(jc)


def test_replayed_starcoder2_adaptive_run_matches_the_reference():
    jcfg = JR.get_smoke_config("starcoder2-3b")
    tcfg = TR.get_smoke_config("starcoder2-3b")
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(1))
    jc, je, j_metrics, j_final = _reference_adaptive_run(
        jcfg, jp, JRun(**_run_kw()))
    lanes = [r["batch_lanes"] for r in jc.trace]
    assert lanes[0] == B_LOC // 2 and lanes[-1] == B_LOC
    eng, state = _replay(tcfg, jax.tree.map(np.asarray, jp),
                         TRun(**_run_kw()), jc.trace)
    _hold_replay(jc, je, j_metrics, j_final, eng, state)


VIT_RUN = dict(peak_lr=6e-3, end_lr=1e-5, alpha=3.5e-3)
VIT_FRONTIER = {0: 1.0, 1: 0.6, 2: 0.5}


def test_replayed_vit_flat_overlap_run_with_a_frontier_matches_the_reference():
    jcfg = dataclasses.replace(JR.get_smoke_config("vit-b16"),
                               n_classes=N_CLASSES)
    tcfg = dataclasses.replace(TR.get_smoke_config("vit-b16"),
                               n_classes=N_CLASSES)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(0))
    stream = jsyn.VisionStream(n_classes=N_CLASSES, seed=42)

    def jbatch(step):
        xs, ys = zip(*[stream.batch(step, i, B_LOC) for i in range(W)])
        return {"images": jnp.stack(xs), "labels": jnp.stack(ys)}
    kw = _run_kw(**VIT_RUN)
    jc, je, j_metrics, j_final = _reference_adaptive_run(
        jcfg, jp, JRun(**kw), batch_fn=jbatch, layout="flat",
        sync="overlap", frontier=VIT_FRONTIER)
    # the run moves both knobs: lanes 2 -> 4, depth 0 -> 1 -> 2 -> 0
    depths = [r["overlap_depth"] for r in jc.trace]
    assert depths[0] == 0 and max(depths) > 0, depths
    assert len(je.batch_epochs) >= 2
    eng, state = _replay(
        tcfg, jax.tree.map(np.asarray, jp), TRun(**kw), jc.trace,
        layout="flat", sync="overlap", batch_fn=tsyn.vision_batch_fn(
            tsyn.VisionStream(n_classes=N_CLASSES, seed=42), W, B_LOC))
    _hold_replay(jc, je, j_metrics, j_final, eng, state)


# ------------------------------------------------------------- microbatch --

def _mb_batch(arch, jcfg):
    if jcfg.family == "vision":
        stream = jsyn.VisionStream(n_classes=jcfg.n_classes, seed=42)
        xs, ys = zip(*[stream.batch(3, i, B_LOC) for i in range(W)])
        return {"images": np.stack(xs), "labels": np.stack(ys)}
    stream = jsyn.TokenStream(vocab=jcfg.vocab, seed=0)
    return {k: np.array(v) for k, v in jsyn.make_train_batch(
        jcfg, stream, 3, W, B_LOC, SEQ).items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mb", [2, 4])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "vit-b16",
                                  "kimi-k2-1t-a32b"])
def test_microbatched_local_step_matches_the_reference(arch, mb, remat):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    kw = dict(_run_kw(schedule="qsr", remat=remat), microbatch=mb)
    jrun, trun = JRun(**kw), TRun(**kw)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(2))
    batch = _mb_batch(arch, jcfg)
    lr = 3e-3
    jstate = JLU.init_state(jcfg, jrun, jp, W)
    jstate, (jloss, jgn) = jax.jit(JLU.make_local_step(
        jcfg, jrun, with_metrics=True))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, lr)
    tstate = TLU.init_state(tcfg, trun, tpm.from_numpy_tree(
        jax.tree.map(np.asarray, jp), "cpu"), W)
    tstate, (tloss, tgn) = TLU.make_local_step(tcfg, trun,
                                               with_metrics=True)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, lr)
    assert _rel(float(jloss), float(tloss)) <= LOSS_TOL
    assert _rel(float(jgn), float(tgn)) <= GRAD_TOL
    # the accumulated gradient, from AdamW's first moment after one step
    # (beta1 0.9, the optimizers' default on both sides)
    scale = 0.1
    jm, tm = jax.tree.leaves(jstate["opt"]["m"]), T.leaves(tstate["opt"]["m"])
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b.numpy() / scale, np.asarray(a) / scale,
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatch_accumulation_is_bitwise_the_references_order(
        mb, monkeypatch):
    """The port adds each chunk's gradient into `.grad` and divides by mb
    once; at a power-of-two mb that is bitwise the reference's `acc + g /
    mb` from zeros, computed here chunk by chunk with `autograd.grad`."""
    tcfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**_run_kw(schedule="qsr"), microbatch=mb)
    seen = {}
    real = TLU.make_optimizer

    def recording(run_cfg):
        opt = real(run_cfg)

        class Recording:
            init = staticmethod(opt.init)

            @staticmethod
            def update(params, opt_state, grads, lr):
                seen["grads"] = T.leaves(grads)
                return opt.update(params, opt_state, grads, lr)
        return Recording()
    monkeypatch.setattr(TLU, "make_optimizer", recording)
    params = tpm.init_params(TLU.api.get_module(tcfg).param_defs(tcfg),
                             torch.Generator().manual_seed(0), device="cpu")
    state = TLU.init_state(tcfg, run, params, W)
    batch = tsyn.make_train_batch(tcfg, tsyn.TokenStream(vocab=tcfg.vocab),
                                  0, W, B_LOC, SEQ)
    leaves, treedef = T.flatten(state["params"])
    loss_fn = TLU.make_loss(tcfg, run)
    n = B_LOC // mb
    acc = [torch.zeros_like(x) for x in leaves]
    for c in range(mb):
        alias = [x.detach().requires_grad_(True) for x in leaves]
        loss = sum(loss_fn(T.unflatten(treedef, [a[i] for a in alias]),
                           {k: v[i, c * n:(c + 1) * n]
                            for k, v in batch.items()}) for i in range(W))
        grads = torch.autograd.grad(loss, alias)
        acc = [a + g / mb for a, g in zip(acc, grads)]
    TLU.make_local_step(tcfg, run)(state, batch, 1e-3)
    assert len(seen["grads"]) == len(acc)
    assert all(torch.equal(a, b) for a, b in zip(seen["grads"], acc))


def test_microbatch_must_divide_the_batch():
    tcfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**_run_kw(schedule="qsr"), microbatch=3)
    step = TLU.make_local_step(tcfg, run)
    state = TLU.init_state(tcfg, run, tpm.init_params(
        TLU.api.get_module(tcfg).param_defs(tcfg),
        torch.Generator().manual_seed(0), device="cpu"), W)
    batch = tsyn.make_train_batch(tcfg, tsyn.TokenStream(vocab=tcfg.vocab),
                                  0, W, B_LOC, SEQ)
    with pytest.raises(ConfigError, match="microbatch 3 does not divide"):
        step(state, batch, 1e-3)


# ------------------------------------------------------------ train() -----

def test_train_adaptive_writes_the_trace_and_moves_the_engine(tmp_path):
    """`train(schedule="adaptive")` builds its engine with the batch knob,
    drives the controller around every round and writes the trace after
    the flush; with a table4 frontier path under overlap the depth
    moves."""
    tcfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**_run_kw())
    front = str(tmp_path / "table4.json")
    with open(front, "w") as f:
        json.dump({"overlap": {"blocking_d0": {"s_per_round": 1.0},
                               "overlap_d1": {"s_per_round": 0.5}}}, f)
    path = str(tmp_path / "trace.json")
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", sync="overlap", adaptive_batch=True,
                           device="cpu")
    _, hist = ttrain.train(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", sync="overlap", eng=eng,
                           controller_trace=path, frontier=front,
                           log_every=0)
    with open(path) as f:
        rec = json.load(f)
    assert rec["schema"] == tctl.TRACE_SCHEMA
    assert rec["frontier"] == {"0": 1.0, "1": 0.5}
    assert rec["summary"]["steps"] == run.total_steps
    assert [(r["t"], r["h"]) for r in rec["rounds"]] == eng.h_trace == \
        [(t - h, h) for t, h, _, _ in hist]
    assert eng.batch_epochs[0].lanes == B_LOC // 2
    assert eng._pending is None
    assert rec["adaptive_depth"] and \
        any(r["overlap_depth"] == 1 for r in rec["rounds"])


def test_resumed_adaptive_run_recalibrates(tmp_path):
    """The controller keeps no state in a checkpoint, as the reference's
    keeps none: a run resumed at a round boundary starts a fresh
    controller, which calibrates again and sets the lanes to b_loc / 2."""
    tcfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**_run_kw())
    ckpt = str(tmp_path / "ckpt")
    kw = dict(workers=W, b_loc=B_LOC, seq=SEQ, data="host", device="cpu",
              ckpt_dir=ckpt, log_every=0)

    class Stop(Exception):
        pass

    def stop_late(t, state):
        if t >= 10:
            raise Stop
    with pytest.raises(Stop):
        ttrain.train(tcfg, run, eval_fn=stop_late, **kw)
    path = str(tmp_path / "trace.json")
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", adaptive_batch=True, device="cpu")
    _, hist = ttrain.train(tcfg, run, eng=eng, controller_trace=path, **kw)
    with open(path) as f:
        rows = json.load(f)["rounds"]
    restored = len(eng.h_trace) - len(rows)
    t0 = rows[0]["t"]
    assert restored > 0 and t0 == eng.h_trace[restored][0] == 6
    assert rows[0]["reasons"][0] == "calibrating"
    assert eng.batch_epochs[0] == teng.BatchEpoch(
        index=0, lanes=B_LOC // 2, b_loc=B_LOC, round_index=restored)
    assert hist[-1][0] == run.total_steps


def test_train_adaptive_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = TR.get_smoke_config("starcoder2-3b")
    with pytest.raises(ConfigError, match="no CUDA device"):
        ttrain.train(tcfg, TRun(**_run_kw()), workers=W, b_loc=B_LOC,
                     seq=SEQ, data="host")


def test_schedules_adaptive_prior_is_the_references():
    kw = _run_kw(total_steps=500, warmup_steps=50)
    jr, tr = JRun(**kw), TRun(**kw)
    jl, tl = jlr.make_lr_fn(jr), tlr.make_lr_fn(tr)
    assert [tsched.get_h(tr, t, tl) for t in range(0, 500, 7)] == \
        [jsched.get_h(jr, t, jl) for t in range(0, 500, 7)]
