"""The port's checkpoints, async observer and train-to-serve path against
the JAX package, on the CPU.

* `checkpoint/wire.py` (the msgpack subset, standard library only) gives
  the bytes `msgpack.packb(x, use_bin_type=True)` gives and reads back what
  `msgpack.unpackb(b, raw=False, strict_map_key=False)` reads; bad bytes
  raise.
* `checkpoint/io.py`: the JAX package's files restore in the port and the
  port's in the JAX package, leaves bitwise and extra equal, and both write
  the same bytes for the same tree and extra.
* Resume: a JAX engine checkpoint (tree layout) continues in the port's
  flat engine to the JAX run's per-round loss, grad norm and divergence
  within 2.2e-6 relative, the largest error `tests/test_torch_lm.py`
  observed over five QSR rounds of the same model (here 1.8e-7: fp32 sums
  in another order, over fewer rounds); the port's `train(ckpt_dir=)`
  stopped and resumed is bitwise its uninterrupted run.
* `AsyncObserver` (latest-wins, merge, errors at drain, snapshots that do
  not alias the state) and `WeightSubscriber.poll` / `serve --watch`, whose
  post-swap tokens equal a server restarted from `load_weights`.
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import registry as JR
from repro.configs.base import RunConfig as JRun
from repro.core import engine as jeng
from repro.core import schedules as jsched
from repro.launch import weights as jweights
from repro.models import param as jpm
from repro.models import transformer as jtf
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint import wire
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.core import schedules as tsched
from repro_torch.core.observer import AsyncObserver, fanout
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch import weights as W
from repro_torch.models import param as tpm
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "starcoder2-3b"
RESUME_TOL = 2.2e-6
W_, B_LOC, SEQ = 2, 2, 16
# the training CLI's run config (launch/train.py main) at 12 steps
RUN = dict(schedule="qsr", optimizer="adamw", total_steps=12, peak_lr=3e-3,
           alpha=0.002, h_base=2, warmup_steps=1, remat=False)


def _mp(x):
    return msgpack.packb(x, use_bin_type=True)


def _mu(b):
    return msgpack.unpackb(b, raw=False, strict_map_key=False)


# ------------------------------------------------------------ the wire ----

def _sized(n):
    return [i % 7 for i in range(n)]


# every int form at its edges, floats, str / bin / array / map at the edges
# of their fix / 8 / 16 / 32-bit forms, and the reference's array record
WIRE_CASES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63],
    "scalars": [None, True, False, 0.0, -1.5, 1e300, float("inf"), 3.25],
    "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
            "f" * 65536],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
    "arrays": [[], _sized(15), _sized(16), _sized(65535), _sized(65536),
               (1, 2, (3, [4]))],
    "maps": [{}, {str(i): i for i in range(15)},
             {str(i): i for i in range(16)},
             {f"k{i}": None for i in range(70000)}],
    "record": {"treedef": "PyTreeDef({'a': *})", "step": 7,
               "extra": {"h_trace": [[0, 2], [2, 2]], "layout": "tree"},
               "leaves": [{b"__nd__": True, b"dtype": "<f4",
                           b"shape": [2, 3], b"data": bytes(range(24))},
                          5, -2.5, "leaf"]},
    "keys": {b"bin": 1, 2: "int", None: [], 1.5: {}, True: b""},
}


@pytest.mark.parametrize("name", list(WIRE_CASES))
def test_wire_bytes_equal_msgpack_on_fixed_cases(name):
    obj = WIRE_CASES[name]
    assert wire.packb(obj) == _mp(obj)
    assert wire.unpackb(_mp(obj)) == _mu(_mp(obj))
    chunks = []
    wire.dump(obj, lambda b: chunks.append(bytes(b)))
    assert b"".join(chunks) == _mp(obj)


def test_wire_reads_float32_and_every_length_form():
    """msgpack writes float32 only when asked (use_single_float), and str8
    only with use_bin_type: the reader takes every form."""
    for obj, kw in ((1.5, dict(use_single_float=True)),
                    ("s" * 40, dict(use_bin_type=False)),
                    ({"a": [1.25, -3.0]}, dict(use_single_float=True))):
        b = msgpack.packb(obj, **kw)
        assert wire.unpackb(b) == _mu(b)


try:
    from hypothesis import given, settings, strategies as st
    _HYP = True
except ImportError:       # the suite runs without hypothesis too
    _HYP = False

if _HYP:
    _ints = st.integers(-2**63, 2**64 - 1)
    # characters of 1 to 4 utf-8 bytes (joined from a list: st.text would
    # write a unicode cache into the test database)
    _text = st.lists(st.sampled_from(list("az0 \u00e9\u00df\u4e2d\u30ab"
                                          "\U0001f600")),
                     max_size=300).map("".join)
    _leaf = (st.none() | st.booleans() | _ints
             | st.floats(allow_nan=False) | _text | st.binary(max_size=300))
    _key = _text | st.binary(max_size=20) | _ints
    _payload = st.recursive(
        _leaf, lambda kids: st.lists(kids, max_size=20)
        | st.dictionaries(_key, kids, max_size=20), max_leaves=60)

    @given(obj=_payload)
    @settings(max_examples=100, deadline=None, database=None)
    def test_wire_matches_msgpack_on_random_payloads(obj):
        b = _mp(obj)
        assert wire.packb(obj) == b
        assert wire.unpackb(b) == _mu(b)


def test_wire_rejects_truncated_and_malformed_bytes():
    b = _mp(WIRE_CASES["record"])
    for n in range(len(b)):
        with pytest.raises(wire.WireError):
            wire.unpackb(b[:n])
    for bad in (b"\xc1", b"\xd4\x01\x02", b"\xc7\x01\x05\x00",
                b"\xa2\xff\xfe", b + b"\x00", b"\x81\x91\x01\x02"):
        with pytest.raises(wire.WireError):
            wire.unpackb(bad)
    for bad in (object(), 2**64, -2**63 - 1, np.float32(1)):
        with pytest.raises(wire.WireError):
            wire.packb(bad)


# ----------------------------------------------------- the two packages ---

@pytest.fixture(scope="module")
def starcoder2():
    jcfg = JR.get_smoke_config(ARCH)
    tcfg = TR.get_smoke_config(ARCH)
    jp = jpm.init_params(jtf.param_defs(jcfg), jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _flat_states(starcoder2):
    """(JAX flat engine state, the same in the port, the port engine,
    the JAX engine), both engines past two rounds' H-trace; every float
    leaf random (numpy), so m and v are not zeros."""
    jcfg, tcfg, jp, npt = starcoder2
    je = jeng.RoundEngine(jcfg, JRun(**RUN), workers=W_, b_loc=B_LOC,
                          seq=SEQ, data="host", layout="flat")
    te = teng.RoundEngine(tcfg, TRun(**RUN), workers=W_, b_loc=B_LOC,
                          seq=SEQ, data="host", layout="flat", device="cpu")
    js = je.init_state(jp)
    rng = np.random.default_rng(3)
    js = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32))
        if x.dtype == jnp.float32 else x + 3, js)
    ts = te.init_state(tpm.from_numpy_tree(npt, "cpu"))
    tl, ttd = T.flatten(ts)
    ts = T.unflatten(ttd, [torch.from_numpy(np.array(x)) for x in
                           jax.tree.leaves(js)])
    je.h_trace = te.h_trace = [(0, 2), (2, 2)]
    return js, ts, te, je


def _files(path):
    return [open(os.path.join(path, n), "rb").read()
            for n in ("state.msgpack", "meta.msgpack")]


def _leaves_equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), T.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_params_files_are_byte_equal_and_cross_restore(starcoder2, tmp_path):
    _, tcfg, jp, npt = starcoder2
    tp = tpm.from_numpy_tree(npt, "cpu")
    extra = {"kind": "serving_weights/v1", "note": "x" * 40, "n": 2**40}
    jio.save(str(tmp_path / "j"), jp, step=9, extra=extra)
    tio.save(str(tmp_path / "t"), tp, step=9, extra=extra)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    got, step, ex = tio.restore_with_meta(str(tmp_path / "j"),
                                          W.params_like(tcfg))
    assert (step, ex) == (9, extra)
    _leaves_equal(jp, got)
    back, step, ex = jio.restore_with_meta(str(tmp_path / "t"), jp)
    assert (step, ex) == (9, extra)
    _leaves_equal(back, tp)
    assert tio.read_meta(str(tmp_path / "j")) == jio.read_meta(
        str(tmp_path / "t"))


def test_flat_engine_state_files_are_byte_equal_and_cross_restore(
        starcoder2, tmp_path):
    js, ts, te, je = _flat_states(starcoder2)
    assert te.checkpoint_extra() == je.checkpoint_extra()
    jio.save(str(tmp_path / "j"), js, step=4, extra=je.checkpoint_extra())
    te.save(str(tmp_path / "t"), ts, step=4)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    like = te.init_state()
    got, step = te.restore(str(tmp_path / "j"), like)
    assert step == 4 and te.h_trace == [(0, 2), (2, 2)]
    _leaves_equal(js, got)
    back, step, extra = jio.restore_with_meta(str(tmp_path / "t"), js)
    assert step == 4 and extra == je.checkpoint_extra()
    _leaves_equal(back, ts)


def test_restore_keeps_like_dtype_and_raises_on_mismatch(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"n": torch.tensor(3, dtype=torch.int32), "s": 4}}
    tio.save(str(tmp_path), tree, step=1)
    got, step = tio.restore(str(tmp_path), {
        "a": torch.zeros(2, 3, dtype=torch.float64),
        "b": {"n": torch.zeros((), dtype=torch.int32), "s": 0}})
    assert got["a"].dtype == torch.float64 and step == 1
    assert torch.equal(got["a"], tree["a"].double()) and got["b"]["s"] == 4
    with pytest.raises(tio.CheckpointError, match="target shape"):
        tio.restore(str(tmp_path), {"a": torch.zeros(3, 2),
                                    "b": {"n": torch.zeros(()), "s": 0}})
    with pytest.raises(tio.CheckpointError, match="holds 3 leaves"):
        tio.restore(str(tmp_path), {"a": torch.zeros(2, 3)})


def test_torn_garbage_and_unknown_dtype_files_raise(tmp_path):
    tree = {"a": torch.ones(64), "b": torch.zeros(3, dtype=torch.int64)}
    tio.save(str(tmp_path / "ok"), tree, step=2)
    state = _files(tmp_path / "ok")[0]
    for name, data in (("torn", state[:len(state) // 2]),
                       ("garbage", b"\xc1not a checkpoint"),
                       ("empty", b""), ("list", _mp([1, 2]))):
        d = tmp_path / name
        d.mkdir()
        (d / "state.msgpack").write_bytes(data)
        with pytest.raises(tio.CheckpointError):
            tio.restore(str(d), tree)
        assert tio.try_read_meta(str(d)) is None
    # a float16 leaf: the JAX package writes "<f2", which no ported path
    # uses; the port names the tag
    jio.save(str(tmp_path / "f16"), {"a": np.ones(2, np.float16)})
    with pytest.raises(tio.CheckpointError, match="'<f2'"):
        tio.restore(str(tmp_path / "f16"), {"a": torch.ones(2)})
    with pytest.raises(tio.CheckpointError, match="float16"):
        tio.save(str(tmp_path / "x"), {"a": torch.ones(2).half()})
    assert tio.try_read_meta(str(tmp_path / "absent")) is None
    assert not tio.exists(str(tmp_path / "absent"))


# ------------------------------------------------------------- resume ----

def test_jax_tree_checkpoint_resumes_in_the_port_flat_engine(starcoder2,
                                                             tmp_path):
    """The JAX engine (tree layout) runs 2 rounds and saves; the port's
    flat engine restores that checkpoint and runs the rest of the schedule
    beside the JAX run: the same H-trace and per-round metrics."""
    jcfg, tcfg, jp, npt = starcoder2
    jrun, trun = JRun(**RUN), TRun(**RUN)
    je = jeng.RoundEngine(jcfg, jrun, workers=W_, b_loc=B_LOC, seq=SEQ,
                          data="host")
    js = je.init_state(jp)
    jlr_fn, t, ck = jlr.make_lr_fn(jrun), 0, None
    j_after = []
    while t < jrun.total_steps:
        h = jsched.get_h(jrun, t, jlr_fn)
        js, m = je.run_round(js, t, h, jlr_fn)
        t += h
        if ck is not None:
            j_after.append({k: float(v) for k, v in m.items()})
        elif len(je.h_trace) == 2:
            ck = str(tmp_path / "ck")
            je.save(ck, js, step=t)
    te = teng.RoundEngine(tcfg, trun, workers=W_, b_loc=B_LOC, seq=SEQ,
                          data="host", layout="flat", device="cpu")
    ts, t = te.restore(ck, te.init_state())
    assert te.h_trace == je.h_trace[:2]
    tlr_fn = tlr.make_lr_fn(trun)
    while t < trun.total_steps:
        h = tsched.get_h(trun, t, tlr_fn)
        ts, _ = te.run_round(ts, t, h, tlr_fn)
        t += h
    assert te.h_trace == je.h_trace and len(j_after) >= 2
    for jm, tm in zip(j_after, te.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert abs(jm[k] - float(tm[k])) <= RESUME_TOL * abs(jm[k]), \
                (k, jm, tm)


class _Crash(RuntimeError):
    pass


def _train(tmp, *, layout, sync, async_observer, crash_at=None,
           ckpt=True):
    cfg = TR.get_smoke_config(ARCH)
    run = TRun(**{**RUN, "total_steps": 8})
    eng = teng.RoundEngine(cfg, run, workers=W_, b_loc=B_LOC, seq=8,
                           data="host", layout=layout, sync=sync,
                           device="cpu")
    if crash_at is not None:
        inner = eng.run_round

        def run_round(state, t, h, lr_fn):
            if t == crash_at:
                raise _Crash(f"killed at step {t}")
            return inner(state, t, h, lr_fn)
        eng.run_round = run_round
    return ttrain.train(cfg, run, workers=W_, b_loc=B_LOC, seq=8,
                        data="host", layout=layout, sync=sync, eng=eng,
                        ckpt_dir=str(tmp) if ckpt else None,
                        async_observer=async_observer, log_every=0)


@pytest.mark.parametrize("layout,sync,async_observer", [
    ("tree", "blocking", False), ("flat", "blocking", True),
    ("flat", "overlap", False)])
def test_train_stopped_and_resumed_is_bitwise_uninterrupted(
        tmp_path, layout, sync, async_observer):
    """Checkpoints land every 2 steps; a crash entering the round at step
    4 leaves the one written there; the rerun resumes from it and ends bitwise
    where the uninterrupted run (checkpointing alike: under overlap a
    checkpoint is a sync point) ends."""
    kw = dict(layout=layout, sync=sync, async_observer=async_observer)
    want, _ = _train(tmp_path / "a", **kw)
    with pytest.raises(_Crash):
        _train(tmp_path / "b", crash_at=4, **kw)
    assert tio.read_meta(str(tmp_path / "b"))[0] == 4
    got, hist = _train(tmp_path / "b", **kw)
    assert [t for t, *_ in hist] == [6, 8]
    assert tio.read_meta(str(tmp_path / "b"))[0] == 8
    for a, b in zip(T.leaves(want), T.leaves(got)):
        assert torch.equal(a, b)
    _, hist = _train(tmp_path / "b", **kw)         # nothing left to do
    assert hist == []


def test_overlap_save_raises_pending_or_writes_the_synced_view(tmp_path):
    cfg = TR.get_smoke_config(ARCH)
    run = TRun(**RUN)
    eng = teng.RoundEngine(cfg, run, workers=W_, b_loc=B_LOC, seq=8,
                           data="host", sync="overlap", device="cpu")
    state = eng.init_state()
    state, _ = eng.run_round(state, 0, 2, tlr.make_lr_fn(run))
    with pytest.raises(teng.PendingSyncError):
        eng.save(str(tmp_path), state, step=2)
    with pytest.raises(teng.PendingSyncError):
        eng.restore(str(tmp_path), state)
    pending = eng._pending
    eng.save(str(tmp_path), state, step=2, flush_pending=True)
    assert eng._pending is pending                  # the pipeline untouched
    got, _ = tio.restore(str(tmp_path), state)
    view = eng.synced_view(state)
    for a, b in zip(T.leaves(view), T.leaves(got)):
        assert torch.equal(a, b)
    assert not torch.equal(T.leaves(view["params"])[0],
                           T.leaves(state["params"])[0])


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    cli = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "8",
           "--workers", "2", "--batch", "2", "--seq", "8",
           "--ckpt", str(tmp_path), "--async-observer"]
    _, hist = ttrain.main(cli)
    assert len(hist) == 4 and tio.read_meta(str(tmp_path))[0] == 8
    _, hist = ttrain.main(cli + ["--param-layout", "flat"])
    out = capsys.readouterr().out
    assert hist == [] and "restored checkpoint at round boundary 8" in out


# ----------------------------------------------------------- observer ----

def test_observer_latest_wins_and_merge():
    gate, seen = threading.Event(), []

    def slow(step, snap):
        gate.wait(10)
        seen.append((step, snap))

    with AsyncObserver(slow, stage=lambda x: x, merge=lambda old, new: (
            {**new, "save": True} if old["save"] else new)) as obs:
        obs.submit(1, {"save": False})
        while obs._queued is not None:              # the worker took it
            pass
        obs.submit(2, {"save": True})
        obs.submit(3, {"save": False})              # supersedes 2, keeps save
        gate.set()
        obs.drain()
        assert obs.stats() == {"submitted": 3, "processed": 2, "dropped": 1}
    assert seen == [(1, {"save": False}), (3, {"save": True})]


def test_observer_handler_errors_surface_at_drain_and_close():
    def boom(step, snap):
        raise ValueError(f"observer failed at {step}")
    obs = AsyncObserver(fanout(lambda s, x: None, boom))
    obs.submit(5, {"x": torch.ones(2)})
    with pytest.raises(ValueError, match="failed at 5"):
        obs.drain()
    with pytest.raises(RuntimeError, match="closed"):
        obs.submit(6, {})
    obs.close()


def test_observer_snapshot_does_not_alias_the_next_round(tmp_path):
    """A snapshot submitted after round r holds round r's values after
    round r+1 has run (the port updates state in place) and after the
    caller writes into the state."""
    cfg = TR.get_smoke_config(ARCH)
    run = TRun(**RUN)
    eng = teng.RoundEngine(cfg, run, workers=W_, b_loc=B_LOC, seq=8,
                           data="host", layout="flat", device="cpu")
    lr_fn = tlr.make_lr_fn(run)
    state, _ = eng.run_round(eng.init_state(), 0, 2, lr_fn)
    want = T.map(torch.clone, state)
    gate, seen = threading.Event(), []

    def handler(step, snap):
        gate.wait(10)
        seen.append(snap)

    obs = AsyncObserver(handler)
    obs.submit(2, state)
    state, _ = eng.run_round(state, 2, 2, lr_fn)
    for x in T.leaves(state["params"]):
        x.add_(1.0)
    gate.set()
    obs.close()
    for a, b in zip(T.leaves(want), T.leaves(seen[0])):
        assert torch.equal(a, b)


# ---------------------------------------------------- train to serve -----

def _serve(cfg, weights, prompts, *, sub=None, hooks=()):
    return tserve.run_service(cfg, weights, prompts, slots=2, max_new=8,
                              max_len=24, subscriber=sub, hooks=hooks)


def test_weight_subscriber_polls_a_watch_dir(starcoder2, tmp_path):
    _, tcfg, jp, npt = starcoder2
    watch = str(tmp_path / "watch")
    sub = W.WeightSubscriber(watch_dir=watch, like=W.params_like(tcfg))
    sub.poll()
    assert sub.take() is None                       # nothing published yet
    jweights.publish_weights(watch, jp, step=3)     # the JAX package's file
    sub.poll()
    step, source, got = sub.take()
    assert (step, source) == (3, f"watch:{watch}")
    _leaves_equal(jp, got)
    sub.poll()
    assert sub.take() is None                       # step 3 already seen
    W.publish_weights(watch, tpm.from_numpy_tree(npt, "cpu"), step=5)
    params, step, extra = W.load_weights(watch, W.params_like(tcfg))
    assert step == 5 and extra["kind"] == W.WEIGHTS_KIND
    _leaves_equal(jp, params)
    with pytest.raises(ValueError, match="needs a `like`"):
        W.WeightSubscriber(watch_dir=watch).poll()
    (tmp_path / "watch" / "meta.msgpack").write_bytes(b"\xc1")
    sub.poll()                                      # torn: retried later
    assert sub.take() is None


def test_serving_weights_from_buckets_takes_them_as_they_are():
    """`ServingWeights.from_buckets` serves the given dtype buckets with no
    copy: the model's tree views them, and a swap writes into them."""
    cfg = TR.get_smoke_config(ARCH)
    w0 = W.ServingWeights.from_seed(cfg, 0, device="cpu")
    bufs = {b: v.clone() for b, v in w0.bufs.items()}
    w = W.ServingWeights.from_buckets(cfg, w0.spec, bufs, step=3)
    assert all(w.bufs[b] is bufs[b] for b in bufs)
    assert w.step == 3 and w.epoch == 0 and w.device == torch.device("cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(T.leaves(w.as_tree()), T.leaves(w0.as_tree())))
    fresh = W.ServingWeights.from_seed(cfg, 9, device="cpu")
    w.swap(fresh.as_tree(), step=4)
    assert all(torch.equal(bufs[b], fresh.bufs[b]) for b in bufs)


def test_watched_swap_mid_sequence_equals_a_restart_from_load_weights(
        tmp_path):
    """A training run's publish lands in the watch dir mid-decode: the
    server swaps, and its post-swap tokens equal a server restarted from
    `load_weights` of that dir, fed the prompt and the pre-swap tokens."""
    cfg = TR.get_smoke_config(ARCH)
    watch = str(tmp_path)
    w0 = W.ServingWeights.from_seed(cfg, 0, device="cpu")
    fresh = W.ServingWeights.from_seed(cfg, 9, device="cpu").as_tree()
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, 5, np.int32)
    sub = W.WeightSubscriber(watch_dir=watch, like=W.params_like(cfg))
    reqs, audit = _serve(cfg, w0, [prompt], sub=sub, hooks=[
        (len(prompt) + 2, lambda b: W.publish_weights(watch, fresh,
                                                      step=7))])
    (req,) = reqs
    assert audit["swaps"] == 1 and req.epochs == [0] * 3 + [1] * 5
    assert audit["swap_epochs"][1]["source"] == f"watch:{watch}"
    params, step, _ = W.load_weights(watch, W.params_like(cfg))
    (rref,), _ = _serve(cfg, W.ServingWeights(cfg, params, step=step,
                                              device="cpu"),
                        [np.concatenate([prompt, np.asarray(req.out[:3],
                                                            np.int32)])])
    assert rref.out[:5] == req.out[3:]


def test_serve_cli_watch_and_swap_demo(tmp_path):
    """`--watch DIR` swaps weights published there before the service
    starts in at the first step; `--swap-demo` publishes through a watch
    dir mid-decode."""
    cfg = TR.get_smoke_config(ARCH)
    W.publish_weights(str(tmp_path), W.ServingWeights.from_seed(
        cfg, 5, device="cpu").as_tree(), step=2)
    base = ["--smoke", "--arch", ARCH, "--device", "cpu", "--slots", "2",
            "--batch", "3", "--prompt-len", "6", "--gen", "6"]
    audit = tserve.main(base + ["--watch", str(tmp_path)])
    assert audit["swaps"] == 1
    assert all(set(r["epochs"]) == {1} for r in audit["requests"])
    audit = tserve.main(base + ["--swap-demo", "--audit",
                                str(tmp_path / "a.json")])
    assert audit["swaps"] == 1 and audit["tokens_emitted"] == 18
    assert audit["swap_epochs"][1]["source"].startswith("watch:")
    assert json.loads((tmp_path / "a.json").read_text())["swaps"] == 1
