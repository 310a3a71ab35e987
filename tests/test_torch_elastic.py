"""The port's elastic rounds and fault injection on the CPU
(`launch/multihost.py`: `Heartbeat`, `_parse_chaos`, `norms_close`,
`run_elastic_worker`, `run_elastic`), asserting what the JAX package's
`tests/test_chaos.py` asserts of its own controller.

* Unit tests: the heartbeat names exactly the silent peers within its
  timeout; chaos specs parse as the reference's; `norms_close` is the
  reference's tolerance rule (compared with the JAX package's function).
* `--chaos kill:worker=2,round=1` through the CLI (`--spawn 4 --chaos ...
  --out`): rank 2 exits 7 at round 1, the three others exit 3 with the
  unanimous verdict (missing [2], resume round 1); three ranks finish the
  run from the round-1 manifest, their consensus (params + anchor) bitwise
  a one-process 3-lane run resuming the same manifest and the moments
  within the norms tolerance.
* `--chaos preempt-restore` through `run_elastic`: then four ranks rejoin
  the lost lane from the manifest and run two more rounds within 1e-5 of
  the one-process 4-lane run's norms and 1e-4 of its losses.

Every rank runs on the CPU over gloo, one torch thread each, with a
heartbeat timeout of 8 s; every spawn has its own timeout.
"""
import json
import subprocess
import sys
import time

import pytest

from repro.launch import multihost as jmh
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.launch import multihost as mh
from torch_mesh_util import ROOT, _env

HB_TIMEOUT = 8
SPAWN_TIMEOUT = 240


# ------------------------------------------------------------- units ---

def test_heartbeat_names_the_silent_peers(tmp_path):
    hbs = [mh.Heartbeat(str(tmp_path), p, 3, timeout=0.3, poll=0.01)
           for p in range(3)]
    hbs[0].announce(0)
    hbs[1].announce(0)
    t0 = time.monotonic()
    assert hbs[0].await_peers(0) == [2]
    assert 0.3 <= time.monotonic() - t0 < 5
    hbs[2].announce(0)
    assert [h.await_peers(0) for h in hbs] == [[], [], []]
    # another round's announcements do not vouch for this one
    hbs[0].announce(1)
    assert hbs[0].await_peers(1) == [1, 2]


@pytest.mark.parametrize("spec", [
    "", "kill:worker=2,round=1", "preempt-restore",
    "preempt-restore:worker=0,round=2", "kill:round=1"])
def test_parse_chaos_is_the_reference(spec):
    assert mh._parse_chaos(spec) == jmh._parse_chaos(spec)


@pytest.mark.parametrize("a,b", [
    ({"x": [1.0, 0.5]}, {"x": [1.0 + 5e-6, 0.5]}),
    ({"x": [1.0, 0.5]}, {"x": [1.0 + 2e-5, 0.5]}),
    ({"x": [100.0, 0.5]}, {"x": [100.0 + 5e-4, 0.5]}),
    ({"x": [0.0, 0.0]}, {"x": [9e-6, 0.0]}),
    ({"x": [1.0, 0.5]}, {"y": [1.0, 0.5]}),
    ({}, {}),
    (None, {"x": [1.0, 1.0]}),
])
def test_norms_close_is_the_reference(a, b):
    assert mh.norms_close(a, b) == jmh.norms_close(a, b)


def test_run_elastic_refuses_bad_specs():
    with pytest.raises(ValueError, match="unknown chaos"):
        mh.run_elastic(4, rounds=3, chaos="explode")
    with pytest.raises(ValueError, match="out of range"):
        mh.run_elastic(4, rounds=3, chaos="kill:worker=4,round=1")
    with pytest.raises(ValueError, match="out of range"):
        mh.run_elastic(4, rounds=3, chaos="kill:worker=1,round=3")


# ------------------------------------------------------ chaos stories ---

def _check_common(tel, *, generations):
    assert tel["ok"], json.dumps(tel, indent=2)[:3000]
    gens = tel["generations"]
    assert len(gens) == generations
    g0 = gens[0]
    assert g0["detect_ok"], g0
    # the victim died with the victim's rc; the survivors exited with the
    # membership verdict's rc and a unanimous verdict
    assert g0["rcs"][2] == 7
    assert all(rc == 3 for i, rc in enumerate(g0["rcs"]) if i != 2)
    assert len(g0["verdicts"]) == 3
    assert all(v["missing"] == [2] and v["resume_round"] == 1
               and v["status"] == "membership-change"
               for v in g0["verdicts"])
    g1 = gens[1]
    assert g1["lanes"] == 3
    assert all(rc == 0 for rc in g1["rcs"] + g1["reference_rcs"])
    assert g1["rounds_redone"] == 2
    # the consensus bitwise; the moments within the norms tolerance
    assert g1["bitwise_vs_single_process"] and g1["shards_compared"], g1
    assert g1["moments_tolerance_ok"], g1
    assert len(g1["losses"]) == 2
    return gens


def test_kill_mid_run_survivors_complete_on_reduced_mesh(tmp_path):
    out = tmp_path / "tel.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--spawn",
         "4", "--chaos", "kill:worker=2,round=1", "--quantize", "--device",
         "cpu", "--heartbeat-timeout", str(HB_TIMEOUT), "--workdir",
         str(tmp_path / "kill"), "--timeout", str(SPAWN_TIMEOUT),
         "--out", str(out)],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=3 * SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    tel = json.loads(out.read_text())
    assert mh.last_json(proc.stdout) == tel
    assert tel["mode"] == "elastic-controller" and tel["workers"] == 4
    assert tel["kill"] == {"worker": 2, "round": 1}
    _check_common(tel, generations=2)


def test_preempt_restore_worker_rejoins_from_manifest(tmp_path,
                                                      monkeypatch):
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    tel = mh.run_elastic(4, rounds=3, chaos="preempt-restore",
                         workdir=str(tmp_path / "pr"),
                         heartbeat_timeout=HB_TIMEOUT,
                         timeout=SPAWN_TIMEOUT, device="cpu")
    gens = _check_common(tel, generations=3)
    g2 = gens[2]
    assert g2["lanes"] == 4
    assert g2["rejoined_from"] == "manifest" and g2["extra_rounds"] == 2
    assert all(rc == 0 for rc in g2["rcs"] + g2["reference_rcs"])
    assert g2["tolerance_vs_single_process"] and g2["shards_compared"], g2
    assert len(g2["losses"]) == len(g2["reference_losses"]) == 2
    # the live generations' rolling manifest ends at gen 2's last round,
    # the one-process reference's twin in its own copy of the workdir
    assert ckpt_io.read_manifest_meta(str(tmp_path / "pr" / "ckpt"))[0] == 10
    assert ckpt_io.read_meta(str(tmp_path / "pr" / "ref2" / "ckpt-mono"))[0] \
        == 10
