"""The port's multi-process sync harness against the JAX package's: the
configurations `tests/test_torch_mesh_sync.py` leaves out, held the same
way (the JAX run with JAX_DISABLE_JIT=1, `tests/torch_mesh_util.py`).

* `4x1` dp with the membership mask 1,1,0,1 (the partial sync; quantized,
  its consensus also equals a run over the participant rows alone:
  `participant_exact`);
* `2x2` dp plain f32 (W = 2: one f32 addition has one order);
* `4x2` dp quantized: 8 ranks, the reference's acceptance mesh;
* `4x1` dp on the ring-int8 wire, 2 rounds (the eager reference's ring
  takes ~40 s a round): every rank within `ring_tolerance` of its host
  ring, the host digest equal (the port's `ring_codes_host` is bitwise the
  reference's), the shard keys equal.
"""
import pytest
from torch_mesh_util import _procs, check_config, run_configs

CONFIGS = {
    "4x1-dp-membership": ("4x1", "dp",
                          ["--quantize", "--membership", "1,1,0,1"]),
    "2x2-dp-f32": ("2x2", "dp", []),
    "4x2-dp-quantize": ("4x2", "dp", ["--quantize"]),
    "4x1-dp-ring": ("4x1", "dp", ["--wire", "ring-int8", "--rounds", "2"]),
}
WIRE = {"4x1-dp-membership": "int16", "2x2-dp-f32": "float32",
        "4x2-dp-quantize": "int16", "4x1-dp-ring": "int8"}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_configs(CONFIGS, tmp_path_factory)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sync_matches_the_jax_package(results, name):
    ring = name.endswith("ring")
    jr, recs = check_config(results[name], ring=ring)
    assert len(recs) == _procs(CONFIGS[name][0])
    assert jr["wire_dtype"] == WIRE[name]
    if name.endswith("membership"):
        assert jr["participant_exact"] is True
        assert all(r["participant_exact"] is True for r in recs)
    if ring:
        assert all(r["max_abs_diff"] <= r["ring_tol"] for r in recs)
