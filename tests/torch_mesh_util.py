"""Helpers of the port's multi-process tests: spawning the JAX package's
sync harness and the port's, and holding one against the other
(`tests/test_torch_mesh_sync*.py`, `tests/test_torch_mesh.py`).

The JAX run is made with JAX_DISABLE_JIT=1.  Jitted, XLA rewrites the
reference's `scale / 127` as `scale * (1 / 127)` and contracts `anchor +
q * s` into a fused multiply-add, so a jitted run's f32 bucket differs from
the reference's ops as written in the last bit of a few elements (16 of
1,324 after one round at W = 2); eager, the reference runs its ops as
written, which the port's plain versions equal bitwise.
"""
import json
import os
import subprocess
import sys

from repro_torch.launch.multihost import last_json as _last_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _procs(mesh: str) -> int:
    n = 1
    for d in mesh.split("x"):
        n *= int(d)
    return n


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def jax_reference(mesh, policy, flags):
    return subprocess.Popen(
        [sys.executable, "-m", "repro.launch.multihost", "--total-devices",
         str(_procs(mesh)), "--mode", "sync", "--mesh", mesh, "--policy",
         policy, *flags], cwd=ROOT, env=_env(JAX_DISABLE_JIT="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def port_ranks(mesh, policy, flags, tmp, timeout=300):
    """The port's ranks' JSON lines (one per rank) and the spawner's rc."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--spawn",
         str(_procs(mesh)), "--mode", "sync", "--mesh", mesh, "--policy",
         policy, "--device", "cpu", "--store-dir", str(tmp),
         "--timeout", str(timeout - 30), *flags],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=timeout)
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    return out.returncode, recs, out.stderr[-3000:]


def run_configs(configs, tmp_path_factory):
    """{name: (jax record, port rc, port records, port stderr)}: the JAX
    references started together, the port's spawns meanwhile."""
    jax_procs = {k: jax_reference(*v) for k, v in configs.items()}
    out = {}
    try:
        for k, v in configs.items():
            out[k] = port_ranks(*v, tmp_path_factory.mktemp(k))
        for k, p in jax_procs.items():
            so, se = p.communicate(timeout=400)
            out[k] = (_last_json(so),) + out[k] + (se[-3000:],)
    finally:
        for p in jax_procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def check_config(res, ring=False):
    jr, rc, recs, port_err, jax_err = res
    assert jr is not None and jr["ok"], jax_err
    assert rc == 0 and recs, port_err
    assert all(r["ok"] for r in recs)
    assert {r["digest"] for r in recs} == {jr["digest"]}
    assert {r["wire_dtype"] for r in recs} == {jr["wire_dtype"]}
    hashes = {}
    for r in recs:
        hashes.update(r["shard_hashes"])
    assert set(hashes) == set(jr["shard_hashes"])
    if not ring:
        assert hashes == jr["shard_hashes"]
    return jr, recs
