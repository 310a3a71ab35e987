"""The port's mesh of ranks on the CPU: one process a rank over gloo with a
file store in the test's temporary directory (no port to race for), every
spawn with a timeout.

* The int16 wire: the reduce-scatter of int16 codes (a ring of int8 views)
  is bitwise the int16 sums at W = 2, 3 and 4, with an odd chunk length,
  and its wire-byte count is int16's; the all-gather of int16 codes too.
* The probe: every verb on 2 and 4 ranks, checked against local values.
* The mesh engine across processes (`multihost --mode engine`, starcoder2-3b
  smoke, 2x2 dp, W = 2 x S = 2, quantized, 3 rounds): every rank's chunks
  bitwise the port's single-process mesh-less engine at the same W; the
  losses every rank reports equal; overlap at depth 0 bitwise blocking;
  depth 1 within 1e-6 of the mesh-less correction form.
* The train CLI `--mesh 2x1 --param-layout flat_sharded` spawned on 2 ranks
  completes its 4 steps; a mesh engine refuses `save` / `restore` (naming
  `save_sharded` / `restore_elastic`) and a lane resize (naming the
  checkpoint-and-respawn route).
* A mesh engine takes the reference's `batch_fn(step) -> [W, B_loc, ...]`:
  on a 2-rank mesh at the starcoder2 smoke config, rounds on a W-lane
  `make_train_batch` are bitwise the rounds on the rank's own lane
  (`lanes=[i]`), a one-lane batch is taken as it is, and a 3-lane batch at
  W = 2 raises ConfigError.
"""
import json
import os
import subprocess
import sys

import pytest
from torch_mesh_util import _env, _last_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 240


def _spawn_code(n, code, tmp):
    """Run `code` on n ranks; their last JSON lines."""
    from repro_torch.launch import multihost
    env = _env()
    res = multihost.spawn_workers(n, argv=[sys.executable, "-c", code],
                                  timeout=TIMEOUT, store_dir=str(tmp),
                                  env=env)
    outs = []
    for rc, so, se in res:
        assert rc == 0, se[-3000:]
        outs.append(_last_json(so))
    return outs


def _multihost(n, tmp, *args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--spawn",
         str(n), "--device", "cpu", "--store-dir", str(tmp), "--timeout",
         str(TIMEOUT - 30), *args], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=TIMEOUT)
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(recs) == n
    return recs


INT16_CODE = r'''
import json, numpy as np, torch, torch.distributed as dist
from repro_torch.launch import multihost
from repro_torch.launch.mesh import Mesh
multihost.initialize(backend="gloo")
n = dist.get_world_size(); r = dist.get_rank()
m = Mesh((n,), ("data",), backend="gloo", device="cpu")
grp = m.groups(("data",)).world
chunk = 7                                   # odd: the int8 view is 14 bytes
codes = [torch.from_numpy(np.random.RandomState(i).randint(
    -127, 128, size=n * chunk)).to(torch.int16) for i in range(n)]
got = m.reduce_scatter_sum(codes[r], grp)
want = sum(c.int() for c in codes).to(torch.int16).view(n, chunk)[r]
ag = m.all_gather(got, grp)
out = {"dtype": str(got.dtype), "sum_ok": bool(torch.equal(got, want)),
       "gather_ok": bool(torch.equal(ag, sum(c.int() for c in codes).to(
           torch.int16))),
       "stats": {"calls": m.stats.calls, "wire_bytes": m.stats.wire_bytes}}
dist.destroy_process_group()
print(json.dumps(out))
'''


@pytest.mark.parametrize("n", [2, 3, 4])
def test_int16_ring_reduce_scatter_is_exact(tmp_path, n):
    outs = _spawn_code(n, INT16_CODE, tmp_path)
    chunk = 7
    for o in outs:
        assert o["dtype"] == "torch.int16"
        assert o["sum_ok"] and o["gather_ok"]
        # int16 on the wire: (n - 1) / n of the n * chunk codes at 2 bytes
        assert o["stats"]["wire_bytes"]["reduce_scatter"] == \
            (n - 1) * chunk * 2
        assert o["stats"]["wire_bytes"]["all_gather"] == (n - 1) * chunk * 2
        assert o["stats"]["calls"] == {"reduce_scatter": 1, "all_gather": 1}


@pytest.mark.parametrize("n", [2, 4])
def test_probe_runs_every_verb(tmp_path, n):
    recs = _multihost(n, tmp_path, "--mode", "probe")
    for r in recs:
        assert r["ok"], r["checks"]
        assert len(r["checks"]) == (14 if n == 4 else 7)


ENGINE_CASES = {
    "blocking": [],
    "overlap_d0": ["--sync", "overlap", "--overlap-depth", "0"],
    "overlap_d1": ["--sync", "overlap", "--overlap-depth", "1"],
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_across_processes_matches_single_process(tmp_path, case):
    recs = _multihost(4, tmp_path, "--mode", "engine", "--mesh", "2x2",
                      "--quantize", "--rounds", "3", *ENGINE_CASES[case])
    losses = {tuple(r["losses"]) for r in recs}
    assert len(losses) == 1 and len(recs[0]["losses"]) == 3
    for r in recs:
        assert r["ok"] and r["workers"] == 2
        if case == "overlap_d1":
            assert r["max_abs_diff_vs_single_process"] <= 1e-6
        else:
            assert r["max_abs_diff_vs_single_process"] == 0.0
        if case == "overlap_d0":
            assert r["overlap_matches_blocking"]
            assert r["max_abs_diff_vs_blocking"] == 0.0
    hashes = {}
    for r in recs:
        hashes.update(r["shard_hashes"])
    assert len(hashes) == 4        # params and anchor, 2 shard chunks each


def test_train_cli_on_a_spawned_mesh(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--spawn", "2",
         "--mode", "train", "--store-dir", str(tmp_path), "--timeout",
         str(TIMEOUT - 30), "--", "--arch", "starcoder2-3b", "--smoke",
         "--device", "cpu", "--mesh", "2x1", "--param-layout",
         "flat_sharded", "--workers", "2", "--steps", "4", "--batch", "2",
         "--seq", "16"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    finals = [ln for ln in out.stdout.splitlines()
              if ln.startswith("final loss")]
    # the losses, equal on both ranks (the line's tail has the data time)
    assert len(finals) == 2 and len({f.split(";")[0] for f in finals}) == 1
    assert "2 communication rounds for 4 steps" in finals[0]


REFUSE_CODE = r'''
import json, torch.distributed as dist
from repro_torch.configs import registry as R
from repro_torch.configs.base import RunConfig
from repro_torch.core.engine import MembershipError, RoundEngine
from repro_torch.errors import ConfigError
from repro_torch.launch import multihost
from repro_torch.launch.mesh import Mesh
multihost.initialize(backend="gloo")
m = Mesh((2, 1), ("data", "model"), backend="gloo", device="cpu")
eng = RoundEngine(R.get_smoke_config("starcoder2-3b"),
                  RunConfig(sync_quantize=True), workers=2, b_loc=2, seq=8,
                  data="host", layout="flat_sharded", mesh=m)
st = eng.init_state()
out = {}
for name, fn, err in (
        ("save", lambda: eng.save("unused", st, step=0), ConfigError),
        ("restore", lambda: eng.restore("unused", st), ConfigError),
        ("resize", lambda: eng.membership_epoch(state=st, keep_lanes=[0]),
         MembershipError)):
    try:
        fn()
        out[name] = "no error"
    except err as e:
        out[name] = str(e)
out["params"] = sorted(eng.params_single(st))[:2]
dist.destroy_process_group()
print(json.dumps(out))
'''


def test_mesh_engine_refuses_checkpoints_and_resizes(tmp_path):
    for o in _spawn_code(2, REFUSE_CODE, tmp_path):
        for name in ("save", "restore"):
            assert "save_sharded" in o[name], o
            assert "restore_elastic" in o[name], o
        assert "mesh" in o["resize"] and "restore_elastic" in o["resize"]
        assert o["params"]


BATCH_CODE = r'''
import json, torch, torch.distributed as dist
from repro_torch import tree as T
from repro_torch.configs import registry as R
from repro_torch.configs.base import RunConfig
from repro_torch.core.engine import RoundEngine
from repro_torch.data.synthetic import TokenStream, make_train_batch
from repro_torch.errors import ConfigError
from repro_torch.launch import multihost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import param as pm
from repro_torch.optim.lr import make_lr_fn
multihost.initialize(backend="gloo")
m = Mesh((2, 1), ("data", "model"), backend="gloo", device="cpu")
i = m.groups(pm.worker_mesh_axes("dp", m)).worker_index
cfg = R.get_smoke_config("starcoder2-3b")
run = RunConfig(schedule="constant", optimizer="adamw", total_steps=4,
                peak_lr=3e-3, warmup_steps=1, h_base=2, remat=False,
                weight_decay=0.01, sync_quantize=True)
lr_fn = make_lr_fn(run)
stream = TokenStream(vocab=max(cfg.vocab, 2), seed=0)

def batches(w, lanes=None):
    return lambda step: make_train_batch(cfg, stream, step, w, 2, 16,
                                         lanes=lanes)

def rounds(batch_fn, n=2):
    eng = RoundEngine(cfg, run, workers=2, b_loc=2, seq=16, data="host",
                      batch_fn=batch_fn, layout="flat_sharded", mesh=m)
    st = eng.init_state()
    losses = []
    for r in range(n):
        st, met = eng.run_round(st, 2 * r, 2, lr_fn)
        losses.append(float(met["loss"]))
    return st, losses

st_w, l_w = rounds(batches(2))
st_1, l_1 = rounds(batches(2, lanes=[i]))
out = {"losses": l_w, "lanes_losses": l_1,
       "bitwise": all(torch.equal(a, b) for a, b in
                      zip(T.leaves(st_w), T.leaves(st_1)))}
# a one-lane batch is the rank's own: worker 0's lane on both ranks
st_0, _ = rounds(batches(2, lanes=[0]), n=1)
st_0w, _ = rounds(lambda step: {k: v[:1] for k, v in
                                batches(2)(step).items()}, n=1)
out["one_lane_as_is"] = all(torch.equal(a, b) for a, b in
                            zip(T.leaves(st_0), T.leaves(st_0w)))
try:
    rounds(batches(3), n=1)
    out["three_lanes"] = "no error"
except ConfigError as e:
    out["three_lanes"] = str(e)
dist.destroy_process_group()
print(json.dumps(out))
'''


def test_mesh_engine_takes_a_w_lane_batch_fn(tmp_path):
    outs = _spawn_code(2, BATCH_CODE, tmp_path)
    for o in outs:
        assert o["bitwise"], o
        assert o["losses"] == o["lanes_losses"]
        assert o["one_lane_as_is"], o
        assert "2 lanes" in o["three_lanes"] and "3 lanes" in \
            o["three_lanes"], o
    assert outs[0]["losses"] == outs[1]["losses"]
