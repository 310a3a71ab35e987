"""The port's sharded manifest checkpoints (`checkpoint/io.py
save_sharded` / `restore_sharded`, `RoundEngine.save_sharded` /
`restore_elastic`) against the JAX package's, on the CPU.  Every
comparison is bitwise.

* Files: one process's manifest, meta and shard file are byte-equal to the
  reference's for the same numpy tree and extra (and for the same engine
  state); the reference's manifests restore in the port and the port's in
  the reference.
* Faults raise CheckpointError: a missing, torn or garbage shard file, a
  torn manifest, a leaf-count or shape mismatch, a block outside its leaf.
  A writer killed between its shard file and the manifest leaves the
  previous step readable; the next whole save removes the orphans.
* `restore_elastic` of the reference's 4-lane manifest (and of its
  monolithic twin) over tree / flat / flat_sharded x W' in {3, 4, 5}
  equals the reference's `RoundEngine.restore_elastic` of the same file.
* Multi-process, gloo CPU ranks over a file store: a manifest written by
  4 ranks (`multihost --mode elastic`) restores under 4, 2 and 1 processes
  with equal `_elastic_hashes` (2 processes keep lanes 0-1: the elastic
  rule), and in the reference's engine as in the port's; on a 2x2 mesh
  (W = 2 x S = 2) each rank's fast path (its own blocks) and the whole
  route give the bits it saved, and mesh-less engines at W = 2 and 3 read
  the same manifest; the reference's one-process manifest restores in 4
  port ranks with the reference's zero-round-probe hashes.

The reference's own elastic worker cannot run a round on this jax (its
mesh engine's vmap refuses mixed shardings), so its manifest is written by
its mesh-less engine in this process, the layout and lanes its worker
writes; the reference's zero-round probe (a restore into its mesh engine)
runs as a subprocess.
"""
import concurrent.futures
import hashlib
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import registry as JR
from repro.configs.base import RunConfig as JRun
from repro.core import engine as jeng
from repro.models import api as japi
from repro.models import param as jpm
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint.io import CheckpointError
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig
from repro_torch.core import flat as tflat
from repro_torch.core.engine import RoundEngine
from repro_torch.launch import multihost as mh
from repro_torch.models import param as tpm
from torch_mesh_util import ROOT, _env
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "starcoder2-3b"
TIMEOUT = 240
RUN = dict(schedule="constant", optimizer="adamw", total_steps=4,
           peak_lr=3e-3, warmup_steps=1, h_base=2, remat=False,
           weight_decay=0.01, sync_quantize=True)


def _np_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(7, 5).astype(np.float32),
            "b": {"c": rng.randn(11).astype(np.float32),
                  "d": np.arange(6, dtype=np.int32)},
            "e": np.array(rng.randn(), np.float32), "step": 42}


def _torch(tree):
    return T.map(lambda a: (torch.from_numpy(a.copy())
                            if isinstance(a, np.ndarray) else a), tree)


def _assert_equal(port_tree, ref_tree):
    lp, tp = T.flatten(port_tree)
    lr, tr = jax.tree.flatten(ref_tree)
    assert len(lp) == len(lr)
    for x, y in zip(lp, lr):
        if isinstance(x, torch.Tensor):
            y = np.asarray(y)
            assert x.dtype == torch.from_numpy(np.zeros(0, y.dtype)).dtype
            np.testing.assert_array_equal(x.numpy(), y)
        else:
            assert x == y


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


# ------------------------------------------------------------ files -----

@pytest.mark.parametrize("step,extra", [(4, {"k": "v", "h": [[0, 2]]}),
                                        (None, None)])
def test_one_process_files_byte_equal_to_reference(tmp_path, step, extra):
    tree = _np_tree()
    jio.save_sharded(str(tmp_path / "ref"), tree, step=step, extra=extra)
    tio.save_sharded(str(tmp_path / "port"), _torch(tree), step=step,
                     extra=extra)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port) == ["manifest.msgpack", "meta.msgpack",
                            "shards-00000000-00000.msgpack" if step is None
                            else "shards-00000004-00000.msgpack"]
    assert port == ref


def test_reference_manifest_restores_in_port_and_back(tmp_path):
    tree = _np_tree(1)
    jio.save_sharded(str(tmp_path / "ref"), tree, step=6, extra={"x": 1})
    got, step, extra = tio.restore_sharded(str(tmp_path / "ref"),
                                           _torch(_np_tree(2)))
    assert (step, extra) == (6, {"x": 1})
    _assert_equal(got, tree)
    assert tio.is_manifest(str(tmp_path / "ref"))
    assert tio.read_manifest_meta(str(tmp_path / "ref")) == (6, {"x": 1})
    tio.save_sharded(str(tmp_path / "port"), got, step=step, extra=extra)
    back, jstep, jextra = jio.restore_sharded(str(tmp_path / "port"),
                                              _np_tree(2))
    assert (jstep, jextra) == (6, {"x": 1})
    _assert_equal(got, back)


def test_manifest_equals_monolithic_one_process(tmp_path):
    tree = _torch(_np_tree(3))
    tio.save(str(tmp_path / "mono"), tree, step=4, extra={"k": "v"})
    tio.save_sharded(str(tmp_path / "man"), tree, step=4, extra={"k": "v"})
    assert not tio.is_manifest(str(tmp_path / "mono"))
    a, sa, ea = tio.restore_with_meta(str(tmp_path / "mono"), tree)
    b, sb, eb = tio.restore_sharded(str(tmp_path / "man"), tree)
    assert sa == sb == 4 and ea == eb == {"k": "v"}
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)


def test_restore_blocks_reads_a_block(tmp_path):
    tree = _torch(_np_tree(4))
    tio.save_sharded(str(tmp_path / "man"), tree, step=2)
    like = {"a": torch.zeros(3, 2), "b": {"c": torch.zeros(4),
                                          "d": torch.zeros(6, dtype=torch.int32)},
            "e": torch.zeros(()), "step": 0}
    blocks = {"a": ((2, 5), (1, 3)), "b": {"c": ((7, 11),), "d": ((0, 6),)},
              "e": (), "step": None}
    got, step, _ = tio.restore_sharded(str(tmp_path / "man"), like,
                                       blocks=blocks)
    assert step == 2 and got["step"] == 42
    assert torch.equal(got["a"], tree["a"][2:5, 1:3])
    assert torch.equal(got["b"]["c"], tree["b"]["c"][7:11])
    assert torch.equal(got["e"], tree["e"])
    with pytest.raises(CheckpointError, match="not inside"):
        tio.restore_sharded(str(tmp_path / "man"), like,
                            blocks=dict(blocks, a=((5, 8), (1, 3))))


# ------------------------------------------------------------ faults ----

def _shard_files(path):
    return [f for f in os.listdir(path) if f.startswith("shards-")]


@pytest.mark.parametrize("fault", ["missing", "truncated", "garbage",
                                   "empty"])
def test_broken_shard_file_raises(tmp_path, fault):
    path = str(tmp_path / "ck")
    tree = _torch(_np_tree())
    tio.save_sharded(path, tree, step=0)
    (name,) = _shard_files(path)
    fname = os.path.join(path, name)
    data = open(fname, "rb").read()
    if fault == "missing":
        os.unlink(fname)
    else:
        with open(fname, "wb") as f:
            f.write({"truncated": data[:len(data) // 2],
                     "garbage": b"\x00\xffnot-msgpack", "empty": b""}[fault])
    match = "missing shard file" if fault == "missing" else "torn or corrupt"
    with pytest.raises(CheckpointError, match=match):
        tio.restore_sharded(path, tree)


def test_torn_manifest_raises(tmp_path):
    path = str(tmp_path / "ck")
    tree = _torch(_np_tree())
    tio.save_sharded(path, tree, step=0)
    full = open(os.path.join(path, "manifest.msgpack"), "rb").read()
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(full[:len(full) // 2])
    with pytest.raises(CheckpointError, match="torn or corrupt"):
        tio.restore_sharded(path, tree)


def test_incomplete_coverage_raises(tmp_path):
    """A manifest naming a shard file whose entries do not cover a leaf."""
    path = str(tmp_path / "ck")
    tree = _torch(_np_tree())
    pl = tio.Placement((14, 5), (((0, 7), (0, 5)), ((7, 14), (0, 5))))
    tio.save_sharded(path, {"a": tree["a"]}, step=0, placement={"a": pl})
    with pytest.raises(CheckpointError, match="missing shard file"):
        tio.restore_sharded(path, {"a": torch.zeros(14, 5)})
    # the missing rank's file, written with no entries: 35 of 70 covered
    tio._write_atomic(path, tio._shard_fname(0, 1), {"entries": []})
    with pytest.raises(CheckpointError, match="cover 35 of 70"):
        tio.restore_sharded(path, {"a": torch.zeros(14, 5)})


@pytest.mark.parametrize("wrong", ["leaves", "shape"])
def test_mismatch_raises(tmp_path, wrong):
    path = str(tmp_path / "ck")
    tree = _torch(_np_tree())
    tio.save_sharded(path, tree, step=0)
    like = ({"only": torch.zeros(3)} if wrong == "leaves"
            else dict(tree, a=torch.zeros(7, 6)))
    with pytest.raises(CheckpointError, match=wrong):
        tio.restore_sharded(path, like)


def test_kill_during_save_leaves_previous_readable(tmp_path):
    path = str(tmp_path / "ck")
    t2, t4 = _torch(_np_tree(2)), _torch(_np_tree(4))
    tio.save_sharded(path, t2, step=2)

    def die():
        raise RuntimeError("killed mid-save")

    with pytest.raises(RuntimeError, match="killed"):
        tio.save_sharded(path, t4, step=4, barrier=die)
    assert sorted(_shard_files(path)) == ["shards-00000002-00000.msgpack",
                                          "shards-00000004-00000.msgpack"]
    got, step, _ = tio.restore_sharded(path, t2)
    assert step == 2 and torch.equal(got["a"], t2["a"])
    # a completed retry supersedes it and removes the orphans
    tio.save_sharded(path, t4, step=4)
    got, step, _ = tio.restore_sharded(path, t4)
    assert step == 4 and torch.equal(got["a"], t4["a"])
    assert _shard_files(path) == ["shards-00000004-00000.msgpack"]
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]


# -------------------------------------------- engines, one process ------

def _jax_engine(layout="flat_sharded", workers=4):
    cfg = JR.get_smoke_config(ARCH)
    run = JRun(**RUN)
    return (jeng.RoundEngine(cfg, run, workers=workers, b_loc=2, seq=16,
                             data="device", layout=layout, sync="partial"),
            jlr.make_lr_fn(run))


def _port_engine(layout="flat_sharded", workers=4):
    return RoundEngine(TR.get_smoke_config(ARCH), RunConfig(**RUN),
                       workers=workers, b_loc=2, seq=16, data="device",
                       layout=layout, sync="partial", device="cpu")


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """The reference's 4-lane run (flat_sharded, partial, quantized), 2
    rounds: its manifest at `<wd>/ckpt` and the monolithic twin."""
    wd = tmp_path_factory.mktemp("ref4")
    eng, lr_fn = _jax_engine()
    st = eng.init_state()
    for r in range(2):
        st, _ = eng.run_round(st, 2 * r, 2, lr_fn)
    eng.save_sharded(str(wd / "ckpt"), st, step=4)
    eng.save(str(wd / "mono"), st, step=4)
    return wd


@pytest.mark.parametrize("workers", [3, 4, 5])
@pytest.mark.parametrize("layout", ["tree", "flat", "flat_sharded"])
def test_restore_elastic_equals_reference(ref_ckpt, layout, workers):
    path = str(ref_ckpt / "ckpt")
    jeng_, _ = _jax_engine(layout, workers)
    want, jstep = jeng_.restore_elastic(path, jeng_.init_state())
    eng = _port_engine(layout, workers)
    got, step = eng.restore_elastic(path, eng.init_state())
    assert step == jstep == 4 and eng.h_trace == jeng_.h_trace == \
        [(0, 2), (2, 2)]
    _assert_equal(got, jax.tree.map(np.asarray, want))
    assert list(eng.membership) == [1.0] * workers


@pytest.mark.parametrize("layout", ["tree", "flat", "flat_sharded"])
def test_restore_elastic_reads_the_monolithic_twin(ref_ckpt, layout):
    a, b = _port_engine(layout, 3), _port_engine(layout, 3)
    got_man, s1 = a.restore_elastic(str(ref_ckpt / "ckpt"), a.init_state())
    got_mono, s2 = b.restore_elastic(str(ref_ckpt / "mono"), b.init_state())
    assert s1 == s2 == 4
    for x, y in zip(T.leaves(got_man), T.leaves(got_mono)):
        assert torch.equal(x, y)


def test_engine_manifest_byte_equal_to_reference(ref_ckpt, tmp_path):
    """The reference's state restored in the port and written again is the
    reference's files, byte for byte; the reference restores it."""
    eng = _port_engine()
    st, step = eng.restore_elastic(str(ref_ckpt / "ckpt"), eng.init_state())
    eng.save_sharded(str(tmp_path / "ckpt"), st, step=step)
    assert _files(tmp_path / "ckpt") == _files(ref_ckpt / "ckpt")
    j, _ = _jax_engine()
    back, jstep = j.restore_elastic(str(tmp_path / "ckpt"), j.init_state())
    assert jstep == 4
    _assert_equal(st, jax.tree.map(np.asarray, back))


def test_initial_state_manifest_byte_equal_to_reference(tmp_path):
    """Both engines' initial state from the reference's params (carried
    across with `from_numpy_tree`), written as manifests: the same bytes,
    and each package restores the other's."""
    j, _ = _jax_engine(workers=3)
    jp = jpm.init_params(japi.get_module(j.cfg).param_defs(j.cfg),
                         jax.random.PRNGKey(0), jax.numpy.float32)
    j.save_sharded(str(tmp_path / "ref"), j.init_state(jp), step=0)
    eng = _port_engine(workers=3)
    st = eng.init_state(tpm.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                            "cpu"))
    eng.save_sharded(str(tmp_path / "port"), st, step=0)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    got, step = eng.restore_elastic(str(tmp_path / "ref"), eng.init_state())
    assert step == 0
    for x, y in zip(T.leaves(got), T.leaves(st)):
        assert torch.equal(x, y)


# ------------------------------------------------------ multi-process ---

def _elastic(n, wd, *, rounds=2, start=0, store=None):
    """`multihost --mode elastic` on n gloo CPU ranks: their records and
    the union of their shard hashes."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--spawn",
         str(n), "--mode", "elastic", "--rounds", str(rounds),
         "--start-round", str(start), "--workdir", str(wd), "--quantize",
         "--device", "cpu", "--store-dir", str(store), "--timeout",
         str(TIMEOUT - 30)], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    assert len(recs) == n and all(r["ok"] for r in recs)
    hashes = {}
    for r in recs:
        hashes.update(r["shard_hashes"])
    return recs, hashes


def _one_process_probe(wd, lanes=4, rounds=2):
    """The port's one-process generation (the mesh-less engine at W =
    lanes), zero rounds: its hashes."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--mode",
         "elastic", "--rounds", str(rounds), "--start-round", str(rounds),
         "--workdir", str(wd), "--quantize", "--device", "cpu",
         "--total-devices", str(lanes)], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = mh.last_json(out.stdout)
    assert rec["ok"] and rec["process_count"] == 1
    return rec["shard_hashes"]


def test_rank_manifest_restores_under_4_2_and_1_processes(tmp_path):
    wd = tmp_path / "w4"
    recs, written = _elastic(4, wd, store=tmp_path / "s0")
    assert {tuple(r["losses"]) for r in recs} and len(recs[0]["losses"]) == 2
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        p4 = pool.submit(_elastic, 4, wd, start=2, store=tmp_path / "s4")
        p2 = pool.submit(_elastic, 2, wd, start=2, store=tmp_path / "s2")
        p1 = pool.submit(_one_process_probe, wd)
        h4, h2, h1 = p4.result()[1], p2.result()[1], p1.result()
    assert len(written) == 13          # 4 lanes x params, m, v + anchor
    assert h4 == written == h1
    # two processes keep lanes 0-1 (the elastic rule), bitwise
    assert sorted(h2) == sorted(k for k in h4 if "(2, 3)" not in k
                                and "(3, 4)" not in k)
    assert all(h4[k] == v for k, v in h2.items())
    # the reference's engine reads the ranks' manifest as the port does
    j, _ = _jax_engine()
    want, jstep = j.restore_elastic(str(wd / "ckpt"), j.init_state())
    eng = _port_engine()
    got, step = eng.restore_elastic(str(wd / "ckpt"), eng.init_state())
    assert step == jstep == 4
    _assert_equal(got, jax.tree.map(np.asarray, want))


MESH_CKPT_CODE = r'''
import hashlib, json, sys, torch, torch.distributed as dist
from repro_torch import tree as T
from repro_torch.configs import registry as R
from repro_torch.configs.base import RunConfig
from repro_torch.core.engine import RoundEngine, _checkpoint_meta
from repro_torch.launch import multihost
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.lr import make_lr_fn
multihost.initialize(backend="gloo")
path = sys.argv[1]
m = Mesh((2, 2), ("data", "model"), backend="gloo", device="cpu")
run = RunConfig(**json.loads(sys.argv[2]))
eng = RoundEngine(R.get_smoke_config("starcoder2-3b"), run, workers=2,
                  b_loc=2, seq=16, data="device", layout="flat_sharded",
                  sync="partial", mesh=m)
st = eng.init_state()
st, _ = eng.run_round(st, 0, 2, make_lr_fn(run))
m.stats.reset()
eng.save_sharded(path, st, step=2)
barriers = m.stats.calls.get("barrier", 0)
fast, step = eng.restore_elastic(path, eng.init_state())
whole, step2, _ = eng._restore_whole(path, eng.init_state(),
                                      *_checkpoint_meta(path))
same = lambda a, b: all(torch.equal(x, y) for x, y in
                        zip(T.leaves(a), T.leaves(b)))
g = eng._groups
out = {"worker": g.worker_index, "shard": g.shard_index, "step": [step, step2],
       "fast": same(fast, st), "whole": same(whole, st),
       "barriers": barriers, "h_trace": eng.h_trace,
       "hashes": [hashlib.sha1(x.contiguous().numpy().tobytes()).hexdigest()
                  for x in T.leaves(st)]}
dist.destroy_process_group()
print(json.dumps(out))
'''


def test_mesh_fast_path_and_whole_route_agree(tmp_path):
    path = tmp_path / "ck"
    res = mh.spawn_workers(
        4, argv=[sys.executable, "-c", MESH_CKPT_CODE, str(path),
                 json.dumps(RUN)], timeout=TIMEOUT, store_dir=str(tmp_path),
        env=_env())
    recs = []
    for rc, so, se in res:
        assert rc == 0, se[-3000:]
        recs.append(mh.last_json(so))
    for r in recs:
        assert r["fast"] and r["whole"], r
        assert r["step"] == [2, 2] and r["h_trace"] == [[0, 2]]
        assert r["barriers"] == 2   # before the manifest, and after
    # one file a rank; the anchor chunks owned by the first worker's ranks
    man = tio._read_payload(str(path), "manifest.msgpack")
    assert man["process_count"] == 4 and len(man["files"]) == 4
    # mesh-less engines read it: W = 2 bitwise every rank's chunks, W = 3
    # adds a clone of lane 0
    for w in (2, 3):
        eng = RoundEngine(TR.get_smoke_config(ARCH), RunConfig(**RUN),
                          workers=w, b_loc=2, seq=16, data="device",
                          layout="flat_sharded", sync="partial", shards=4,
                          device="cpu")
        st, step = eng.restore_elastic(str(path), eng.init_state())
        assert step == 2
        for r in recs:
            mine = tflat.take_slices(st, tflat.flat_state_slices(
                eng.run_cfg, eng.spec, r["worker"], r["shard"], 2))
            assert r["hashes"] == [
                hashlib.sha1(x.contiguous().numpy().tobytes()).hexdigest()
                for x in T.leaves(mine)]
        if w == 3:
            for k in ("params",):
                assert torch.equal(st[k]["float32"][2], st[k]["float32"][0])
            for k in ("m", "v"):
                assert torch.equal(st["opt"][k]["float32"][2],
                                   st["opt"][k]["float32"][0])


def test_reference_manifest_restores_in_port_ranks(ref_ckpt, tmp_path):
    """The reference's one-process 4-lane manifest, restored by its own
    zero-round probe (a subprocess: its mesh engine over 4 devices) and by
    4 port ranks (the fast path: their layout, shards and W)."""
    wd = tmp_path / "port"
    shutil.copytree(ref_ckpt / "ckpt", wd / "ckpt")
    env = _env()
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.multihost", "--total-devices",
         "4", "--mode", "elastic", "--rounds", "2", "--start-round", "2",
         "--quantize", "--workdir", str(ref_ckpt)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, port = _elastic(4, wd, start=2, store=tmp_path / "s")
        so, se = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    rec = mh.last_json(so)
    assert ref.returncode == 0 and rec and rec["ok"], se[-3000:]
    assert rec["status"] == "complete" and rec["process_count"] == 1
    assert len(port) == 13 and port == rec["shard_hashes"]
