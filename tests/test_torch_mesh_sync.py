"""The port's multi-process sync harness against the JAX package's.

For each configuration, `python -m repro.launch.multihost --total-devices N
--mode sync ...` (one process, N simulated devices) and the port's
`python -m repro_torch.launch.multihost --spawn N --mode sync --device cpu
...` (N processes, one rank each, gloo over a file store).  Held:

* `ok` on every rank: its chunks equal its own host path's bitwise (the
  ring within `ring_tolerance`);
* the digests equal (the host reference state, over both dtype buckets);
* the union of the port's `shard_hashes` equals the JAX run's (the same
  global slices; not for the ring, whose mesh path the reference holds to a
  tolerance only);
* `wire_dtype` equal (int16 for the quantized wire at these W).

The JAX run is made with JAX_DISABLE_JIT=1 (`tests/torch_mesh_util.py`
says why: XLA's jit rewrites two of the reference's ops).  Nothing is
loosened: every configuration's digest is compared whole, the bf16 bucket
too.  `tests/test_torch_mesh_sync_b.py` holds the other configurations.

The JAX references of this file run in parallel at its start; the port's
spawns run one after another, each rank on one intra-op thread.  Every
subprocess has a timeout and fails, never hangs.
"""
import pytest
from torch_mesh_util import _procs, check_config, run_configs

CONFIGS = {
    "2x2-dp-quantize": ("2x2", "dp", ["--quantize"]),
    "2x1x2-fsdp-quantize": ("2x1x2", "fsdp", ["--quantize"]),
    "2x2-dp-momentum": ("2x2", "dp", ["--quantize", "--momentum", "0.9"]),
    "2x2-dp-overlap": ("2x2", "dp", ["--quantize", "--overlap"]),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_configs(CONFIGS, tmp_path_factory)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sync_matches_the_jax_package(results, name):
    jr, recs = check_config(results[name])
    mesh = CONFIGS[name][0]
    assert len(recs) == _procs(mesh)
    assert jr["wire_dtype"] == "int16"
    for r in recs:
        assert r["mesh_stats"]["calls"]["reduce_scatter"] > 0
        assert r["mesh_stats"]["calls"]["all_gather"] > 0
