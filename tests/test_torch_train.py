"""The port's training path against the JAX package: schedules, the vision
stream, one local step + sync, and QSR rounds of the RoundEngine at
vit-smoke (16 classes, W = 4, b_loc = 8), the configuration
`examples/vit_local_adamw.py` trains.

Weights come from the JAX package's init, carried across as numpy; batches
come from the two packages' VisionStreams, which draw bitwise the same
numbers.  Tolerances, each with its reason:

* schedules, the H trace and the batches are pure Python / numpy: equal.
* one local step + sync: the two packages' fp32 sums differ by ~1e-7
  relative.  Moments, linear in g and g^2: elementwise 1e-5.  The first
  AdamW step moves each param by lr * g / (|g| + eps), which flips where g
  sits at the sum-order noise, so a few elements in 1e4 move by up to 2 lr
  differently (observed: up to 1.5e-4 of a leaf, with outer momentum).
  Params, anchors and outer momentum: at most 1 element in 2,000 of each
  leaf (and at least one) beyond 1e-5, none beyond 2 lr.
* QSR rounds: per-round loss, grad norm and divergence within 1e-4 relative
  (observed <= 1.6e-5).  Final params: each leaf's relative L2 difference
  within 2e-4 (observed <= 5e-5), every element within 2e-3 (observed
  5.5e-4): AdamW's normalised step m / sqrt(v) is O(1) wherever a gradient
  element sits near the sum-order noise, so such an element may move by up
  to lr (6e-3) per step differently on the two sides.
* inside the port, tree and flat layouts: bitwise.
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
from repro.core import local_update as JLU
from repro.core import schedules as jsched
from repro.core import sync as jsync
from repro.core import flat as jflat
from repro.data.synthetic import VisionStream as JVision
from repro.models import param as jpm
from repro.models import vit as jvit
from repro.optim import lr as jlr
from repro.optim import optimizers as jopt
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.core import flat as tflat
from repro_torch.core import local_update as TLU
from repro_torch.core import schedules as tsched
from repro_torch.core import sync as tsync
from repro_torch.data.synthetic import VisionStream as TVision
from repro_torch.data.synthetic import vision_batch_fn
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import param as tpm
from repro_torch.optim import lr as tlr
from repro_torch.optim import optimizers as topt
from torch_one_thread import one_torch_thread  # noqa: F401

W, B_LOC, N_CLASSES = 4, 8, 16
STEP_TOL = 1e-5
METRIC_TOL = 1e-4
PARAM_REL_TOL, PARAM_ABS_TOL = 2e-4, 2e-3

# the example's run config (examples/vit_local_adamw.py), 12 steps
RUN = dict(schedule="qsr", optimizer="adamw", total_steps=12, peak_lr=6e-3,
           end_lr=1e-5, warmup_steps=1, h_base=2, alpha=3.5e-3,
           weight_decay=0.01, remat=False)


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


def _jax_batch_fn(stream, w=W, b=B_LOC):
    def fn(step):
        xs, ys = zip(*[stream.batch(step, i, b) for i in range(w)])
        return {"images": jnp.stack(xs), "labels": jnp.stack(ys)}
    return fn


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


# ---------------------------------------------------------------- config --

def test_run_config_matches_the_jax_package():
    assert dataclasses.asdict(JRun()) == dataclasses.asdict(TRun())
    assert dataclasses.asdict(JRun(**RUN)) == dataclasses.asdict(TRun(**RUN))


# ------------------------------------------------------------- schedules --

@pytest.mark.parametrize("lr_schedule", ["cosine", "linear", "step"])
@pytest.mark.parametrize("kind", jsched.SCHEDULE_KINDS)
def test_schedules_equal_jax(kind, lr_schedule):
    kw = dict(schedule=kind, lr_schedule=lr_schedule, total_steps=300,
              warmup_steps=20, peak_lr=8e-3, end_lr=1e-5, h_base=2,
              alpha=0.02, beta=0.05, rho=0.01)
    jr, tr = JRun(**kw), TRun(**kw)
    jl, tl = jlr.make_lr_fn(jr), tlr.make_lr_fn(tr)
    assert tsched.SCHEDULE_KINDS == jsched.SCHEDULE_KINDS
    assert [tl(t) for t in range(310)] == [jl(t) for t in range(310)]
    assert [tsched.get_h(tr, t, tl) for t in range(300)] == \
        [jsched.get_h(jr, t, jl) for t in range(300)]
    assert tsched.h_trace(tr, tl) == jsched.h_trace(jr, jl)
    assert tsched.n_rounds(tr, tl) == jsched.n_rounds(jr, jl)
    assert tsched.comm_fraction(tr, tl) == jsched.comm_fraction(jr, jl)


def test_main_path_qsr_trace():
    """The chip run's schedule (24 steps, warmup 2): H grows as the lr
    decays."""
    kw = dict(RUN, total_steps=24, warmup_steps=2)
    tr = TRun(**kw)
    want = [(t, 2) for t in range(0, 16, 2)] + [(16, 3), (19, 5)]
    assert tsched.h_trace(tr, tlr.make_lr_fn(tr)) == want
    assert jsched.h_trace(JRun(**kw), jlr.make_lr_fn(JRun(**kw))) == want


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("image,step,worker,batch",
                         [(32, 0, 0, 8), (32, 17, 3, 5), (224, 4, 1, 2)])
def test_vision_stream_batches_are_bitwise_jax(image, step, worker, batch):
    js, ts = JVision(n_classes=1000, image=image, seed=42), \
        TVision(n_classes=1000, image=image, seed=42)
    for noisy in (True, False):
        jx, jy = js.batch(step, worker, batch, noisy=noisy)
        tx, ty = ts.batch(step, worker, batch, noisy=noisy)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert tx.dtype == torch.float32 and ty.dtype == torch.int32
    fb = vision_batch_fn(ts, 3, batch)(step)
    assert fb["images"].shape == (3, batch, image, image, 3)
    np.testing.assert_array_equal(fb["labels"][1].numpy(),
                                  np.asarray(js.batch(step, 1, batch)[1]))


# --------------------------------------------------- one step + one sync --

STEP_CASES = [("tree-plain", "tree", False, 0.0),
              ("flat-quantized", "flat", True, 0.0),
              ("tree-momentum", "tree", False, 0.9),
              ("flat-quantized-momentum", "flat", True, 0.9)]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_one_local_step_and_sync_match_jax(params, case):
    _, layout, quantize, momentum = case
    jcfg, tcfg = _cfgs()
    kw = dict(RUN, sync_quantize=quantize, outer_momentum=momentum)
    jrun, trun = JRun(**kw), TRun(**kw)
    jp, npt = params
    batch = _jax_batch_fn(JVision(n_classes=N_CLASSES, seed=42))(3)
    lr = 6e-3

    jstate = JLU.init_state(jcfg, jrun, jp, W)
    jspec = tspec = None
    if layout == "flat":
        jspec = jflat.FlatParamSpace(jp)
        jstate = jflat.to_flat_state(jspec, jstate)
    jstate, (jloss, jgn) = jax.jit(JLU.make_local_step(
        jcfg, jrun, with_metrics=True, spec=jspec))(jstate, batch, lr)
    jstate = jax.jit(jsync.make_sync(jrun, spec=jspec))(jstate)

    tp = tpm.from_numpy_tree(npt, "cpu")
    tstate = TLU.init_state(tcfg, trun, tp, W)
    if layout == "flat":
        tspec = tflat.FlatParamSpace(tp)
        tstate = tflat.to_flat_state(tspec, tstate)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tstate, (tloss, tgn) = TLU.make_local_step(
        tcfg, trun, with_metrics=True, spec=tspec)(tstate, tbatch, lr)
    tstate = tsync.make_sync(trun, spec=tspec)(tstate)

    assert _rel(float(jloss), float(tloss)) <= STEP_TOL
    assert _rel(float(jgn), float(tgn)) <= STEP_TOL
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    want = {k: jstate[k] for k in ("params", "anchor", "outer_mu")
            if k in jstate}
    want["m"], want["v"] = jstate["opt"]["m"], jstate["opt"]["v"]
    got = {k: tstate[k] for k in ("params", "anchor", "outer_mu")
           if k in tstate}
    got["m"], got["v"] = tstate["opt"]["m"], tstate["opt"]["v"]
    assert set(got) == set(want)
    for k in want:
        for a, b in zip(jax.tree.leaves(want[k]), T.leaves(got[k])):
            a, b = np.asarray(a), b.numpy()
            if k in ("m", "v"):
                np.testing.assert_allclose(b, a, rtol=STEP_TOL, atol=STEP_TOL)
            else:
                bad = np.abs(a - b) > STEP_TOL * (1 + np.abs(a))
                assert bad.sum() <= max(1, a.size // 2_000), (k, bad.sum())
                assert np.abs(a - b).max() <= 2 * lr, k
    # after the sync every lane holds the consensus
    for x in T.leaves(tstate["params"]):
        assert torch.equal(x, x[:1].expand_as(x))


# ------------------------------------------------------ QSR engine rounds --

def _run_jax_engine(jp):
    jcfg, _ = _cfgs()
    run = JRun(**RUN)
    eng = jeng.RoundEngine(jcfg, run, workers=W, b_loc=B_LOC, seq=1,
                           data="host", layout="tree",
                           batch_fn=_jax_batch_fn(
                               JVision(n_classes=N_CLASSES, seed=42)))
    state = eng.init_state(jp)
    lr_fn, t, metrics = jlr.make_lr_fn(run), 0, []
    while t < run.total_steps:
        h = jsched.get_h(run, t, lr_fn)
        state, m = eng.run_round(state, t, h, lr_fn)
        metrics.append({k: float(v) for k, v in m.items()})
        t += h
    return eng.h_trace, metrics, jax.tree.map(np.asarray,
                                               eng.params_single(state))


def _run_port_engine(npt, layout, **overrides):
    _, tcfg = _cfgs()
    run = TRun(**dict(RUN, **overrides))
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=1,
                           data="host", layout=layout, device="cpu",
                           batch_fn=vision_batch_fn(
                               TVision(n_classes=N_CLASSES, seed=42), W,
                               B_LOC))
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    lr_fn, t = tlr.make_lr_fn(run), 0
    while t < run.total_steps:
        state, _ = eng.run_round(state, t, tsched.get_h(run, t, lr_fn),
                                 lr_fn)
        t = eng.h_trace[-1][0] + eng.h_trace[-1][1]
    return eng, state


@pytest.fixture(scope="module")
def jax_rounds(params):
    return _run_jax_engine(params[0])


def test_engine_qsr_rounds_match_jax_engine(params, jax_rounds):
    j_trace, j_metrics, j_final = jax_rounds
    eng, state = _run_port_engine(params[1], "tree")
    assert eng.h_trace == j_trace
    assert len(j_trace) >= 3 and len({h for _, h in j_trace}) >= 2
    for jm, tm in zip(j_metrics, eng.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert _rel(jm[k], float(tm[k])) <= METRIC_TOL, (k, jm, tm)
    got = T.leaves(eng.params_single(state))
    for a, b in zip(jax.tree.leaves(j_final), got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= PARAM_REL_TOL * np.linalg.norm(a)
        assert np.abs(a - b).max() <= PARAM_ABS_TOL


@pytest.mark.parametrize("quantize,momentum", [(False, 0.0), (True, 0.0),
                                               (True, 0.9)])
def test_tree_and_flat_layouts_are_bitwise_equal(params, quantize, momentum):
    """Inside the port, the flat layout's trajectory (one optimizer and one
    sync launch per bucket) is bitwise the tree layout's: params, moments,
    anchors and the step counter.  Only the scalar metrics' reduction order
    differs."""
    kw = dict(sync_quantize=quantize, outer_momentum=momentum)
    e_tree, s_tree = _run_port_engine(params[1], "tree", **kw)
    e_flat, s_flat = _run_port_engine(params[1], "flat", **kw)
    s_flat = tflat.to_tree_state(e_flat.spec, s_flat)
    lt, td_t = T.flatten(s_tree)
    lf, td_f = T.flatten(s_flat)
    assert td_t == td_f and len(lt) > 48
    for a, b in zip(lt, lf):
        assert torch.equal(a, b)
    for mt, mf in zip(e_tree.round_metrics, e_flat.round_metrics):
        assert _rel(float(mt["loss"]), float(mf["loss"])) <= 1e-6


def test_train_history_matches_the_jax_train_schedule(capsys):
    """`train()` with a passed-in engine walks the same rounds and returns
    (t_end, h, loss, lr) rows; `eval_fn` sees the synced state each round.
    (Its weights are the engine's seeded draw, so losses are only checked
    finite here; the trajectory itself is held against JAX above.)"""
    jcfg, tcfg = _cfgs()
    run = TRun(**RUN)
    eng = teng.RoundEngine(tcfg, run, workers=2, b_loc=2, seq=1, data="host",
                           device="cpu", batch_fn=vision_batch_fn(
                               TVision(n_classes=N_CLASSES, seed=42), 2, 2))
    seen = []

    def eval_fn(t, state):
        seen.append(t)
        for x in T.leaves(state["params"]):
            assert torch.equal(x[0], x[1])

    ops.reset_launch_counts()
    state, hist = ttrain.train(tcfg, run, workers=2, b_loc=2, seq=1,
                               data="host", eng=eng, eval_fn=eval_fn)
    jl = jlr.make_lr_fn(JRun(**RUN))
    want = [(t + h, h, jl(t + h - 1))
            for t, h in jsched.h_trace(JRun(**RUN), jl)]
    assert [(t, h, lr) for t, h, _, lr in hist] == want
    assert seen == [t for t, _, _ in want]
    assert all(np.isfinite(loss) for _, _, loss, _ in hist)
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions
    assert "step     12" in capsys.readouterr().out
    with pytest.raises(ConfigError, match="engine built with"):
        ttrain.train(tcfg, run, workers=4, b_loc=2, seq=1, data="host",
                     eng=eng)


def test_unported_training_options_raise():
    _, tcfg = _cfgs()
    run = TRun(**RUN)
    fn = vision_batch_fn(TVision(n_classes=N_CLASSES), 2, 2)
    base = dict(workers=2, b_loc=2, seq=1, data="host", batch_fn=fn,
                device="cpu")
    # flat_sharded is ported (tests/test_torch_sharded.py); a mesh drives
    # the collective sync of that layout alone, as the reference's does
    assert teng.RoundEngine(tcfg, run, **base,
                            layout="flat_sharded").layout == "flat_sharded"
    with pytest.raises(ConfigError, match="layout=flat_sharded"):
        teng.RoundEngine(tcfg, run, **base, mesh=object())
    # the adaptive batch knob is ported; like the reference's, it rides
    # the bucketed engine only
    assert teng.RoundEngine(tcfg, run, **base, adaptive_batch=True)\
        .adaptive_batch
    with pytest.raises(ConfigError, match="needs mode='bucketed'"):
        teng.RoundEngine(tcfg, run, **base, adaptive_batch=True,
                         mode="legacy")
    # device data (the engine's default) is ported: an LM engine builds
    # its on-device synthesizer (`tests/test_torch_device_data.py`)
    lm = teng.RoundEngine(TR.get_smoke_config("gemma3-4b"), run, workers=2,
                          b_loc=2, seq=8, device="cpu")
    assert lm.data == "device" and lm._batch(0)["tokens"].shape == (2, 2, 8)
    with pytest.raises(ConfigError, match="need data='host'"):
        teng.RoundEngine(tcfg, run, workers=2, b_loc=2, seq=1, device="cpu")
    # the collective sync is ported (tests/test_torch_mesh*.py); on a mesh
    # the ring still refuses a membership mask, as the reference's does
    with pytest.raises(ValueError, match="does not compose with partial"):
        tsync.make_sync_partial(
            TRun(sync_quantize=True, sync_wire="ring-int8"),
            spec=types.SimpleNamespace(mesh=object(), worker_axes=("data",)))


def test_engine_refuses_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(ConfigError, match="no CUDA device"):
        teng.RoundEngine(tcfg, TRun(**RUN), workers=2, b_loc=2, seq=1,
                         data="host", batch_fn=vision_batch_fn(
                             TVision(n_classes=N_CLASSES), 2, 2))


def test_flat_segment_reductions_match_jax(params):
    jp, npt = params
    jspec = jflat.FlatParamSpace(jp)
    tspec = tflat.FlatParamSpace(tpm.from_numpy_tree(npt, "cpu"))
    (b,) = tspec.buckets
    np.testing.assert_array_equal(tspec.segment_ids(b), jspec.segment_ids(b))
    x = np.random.default_rng(1).standard_normal(
        tspec.sizes[b]).astype(np.float32)
    got = tspec.segment_max(b, torch.from_numpy(x))
    want = jspec.segment_max(b, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tspec.spread(b, got).numpy(),
                                  np.asarray(jspec.spread(b, want)))


def test_sgd_and_global_norm_match_jax():
    """The optimizer module's other members: SGD with (Nesterov) momentum
    and weight decay, two steps, and the global gradient norm.  No AdamW
    normalisation here, so every element agrees to fp32 rounding."""
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((3, 5)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), p) for _ in range(2)]
    for nesterov in (False, True):
        jo = jopt.sgd(momentum=0.9, weight_decay=0.01, nesterov=nesterov)
        to = topt.sgd(momentum=0.9, weight_decay=0.01, nesterov=nesterov)
        jp, js = jax.tree.map(jnp.asarray, p), None
        tp = tpm.from_numpy_tree(p, "cpu")
        js, ts = jo.init(jp), to.init(tp)
        for g in grads:
            jp, js = jo.update(jp, js, jax.tree.map(jnp.asarray, g), 0.1)
            tp, ts = to.update(tp, ts, tpm.from_numpy_tree(g, "cpu"), 0.1)
        for a, b in zip(jax.tree.leaves((jp, js["mu"])),
                        T.leaves(tp) + T.leaves(ts["mu"])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == 2
    np.testing.assert_allclose(
        float(topt.global_norm(tpm.from_numpy_tree(grads[0], "cpu"))),
        float(jopt.global_norm(jax.tree.map(jnp.asarray, grads[0]))),
        rtol=1e-6)


def test_make_train_round_is_the_engine_round_bitwise(params):
    """`local_update.make_train_round` (H local steps, then the sync) gives
    the engine's round bitwise: the same step and sync, without the
    telemetry."""
    _, tcfg = _cfgs()
    run = TRun(**RUN)
    fn = vision_batch_fn(TVision(n_classes=N_CLASSES, seed=42), 2, 2)
    tp = tpm.from_numpy_tree(params[1], "cpu")
    eng = teng.RoundEngine(tcfg, run, workers=2, b_loc=2, seq=1, data="host",
                           batch_fn=fn, device="cpu")
    s_eng, m = eng.run_round(eng.init_state(tp), 0, 3, lambda t: 1e-3)
    s_rnd, loss = TLU.make_train_round(tcfg, run)(
        TLU.init_state(tcfg, run, tp, 2), [fn(t) for t in range(3)],
        [1e-3] * 3)
    assert float(loss) == float(m["loss"])
    for a, b in zip(T.leaves(s_eng), T.leaves(s_rnd)):
        assert torch.equal(a, b)
