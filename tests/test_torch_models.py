"""The port's model layers against the JAX package at the gemma3 smoke config.

Weights come from the JAX package's own init and are carried across as
numpy (`from_numpy_tree`); both packages then run the same decode steps on
the same tokens.  The logits agree within 1e-4 (fp32 through 2 layers and
the tied unembed, summed in another order on each side: observed ~2e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import flat as jflat
from repro.models import api as japi
from repro.models import param as jpm
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.core import flat as tflat
from repro_torch.errors import ConfigError, LayoutError
from repro_torch.launch.weights import ServingWeights
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import param as tpm
from torch_one_thread import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-4
ARCH = "gemma3-4b"


@pytest.fixture(scope="module")
def setup():
    jcfg = JR.get_smoke_config(ARCH)
    tcfg = TR.get_smoke_config(ARCH)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, npt


def test_configs_match_the_jax_package():
    for arch in (ARCH, "dbrx-132b", "kimi-k2-1t-a32b"):
        for get in ("get_config", "get_smoke_config"):
            j, t = getattr(JR, get)(arch), getattr(TR, get)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert [j.layer_window(i) for i in range(j.n_layers)] == \
                [t.layer_window(i) for i in range(t.n_layers)]


def test_unported_archs_raise():
    """Every id of the JAX package's registry is ported (NOT_PORTED is
    empty); an unknown id still raises."""
    assert TR.NOT_PORTED == ()
    assert set(TR.ARCHS) == set(JR.ARCHS)
    for get in (TR.get_config, TR.get_smoke_config):
        with pytest.raises(ConfigError, match="unknown arch"):
            get("no-such-arch")


def test_param_defs_and_counts_match(setup):
    jcfg, tcfg, _, _ = setup
    for jc, tc in ((jcfg, tcfg), (JR.get_config(ARCH), TR.get_config(ARCH))):
        jdefs = japi.get_module(jc).param_defs(jc)
        tdefs = tapi.get_module(tc).param_defs(tc)
        jl = jax.tree.leaves(jdefs, is_leaf=jpm.is_def)
        tl = T.leaves(tdefs)
        assert [(d.shape, d.axes, d.init, d.scale) for d in jl] == \
            [(d.shape, d.axes, d.init, d.scale) for d in tl]
        assert tpm.count_params(tdefs) == jpm.count_params(jdefs)
    assert tpm.count_params(tapi.get_module(TR.get_config(ARCH)).param_defs(
        TR.get_config(ARCH))) == 3_879_907_840


def _paths(tree, prefix=()):
    """Key path of every leaf, in sorted-key leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def test_from_numpy_tree_round_trip(setup):
    _, _, jp, npt = setup
    tp = tpm.from_numpy_tree(npt, "cpu")
    jpaths = [tuple(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert _paths(tp) == jpaths
    for a, b in zip(T.leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = T.map(lambda t: t.numpy(), tp)
    for a, b in zip(T.leaves(back), jax.tree.leaves(npt)):
        np.testing.assert_array_equal(a, b)


def test_flat_buckets_bitwise_equal_jax(setup):
    """Same leaf order (sorted keys) and offsets: the port's bucket equals
    the JAX `FlatParamSpace.flatten` bucket element for element."""
    _, _, jp, npt = setup
    tp = tpm.from_numpy_tree(npt, "cpu")
    jb = jflat.FlatParamSpace(jp).flatten(jp)
    tspec = tflat.FlatParamSpace(tp)
    tb = tspec.flatten(tp)
    assert tspec.buckets == tuple(jb) == ("float32",)
    for name in jb:
        np.testing.assert_array_equal(tb[name].numpy(), np.asarray(jb[name]))
    # unflatten gives views into the bucket, equal to the tree
    tree = tspec.unflatten(tb)
    for a, b in zip(T.leaves(tree), T.leaves(tp)):
        assert a.untyped_storage().data_ptr() == \
            tb["float32"].untyped_storage().data_ptr()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flat_lead_axis_and_layout_errors(setup):
    _, _, _, npt = setup
    tp = tpm.from_numpy_tree(npt, "cpu")
    spec = tflat.FlatParamSpace(tp)
    stacked = T.map(lambda t: torch.stack([t, 2 * t]), tp)
    bufs = spec.flatten(stacked, lead=1)
    assert bufs["float32"].shape == (2, spec.sizes["float32"])
    back = spec.unflatten(bufs, lead=1)
    for a, b in zip(T.leaves(back), T.leaves(stacked)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(LayoutError):
        spec.flatten({"embed": tp["embed"]})
    with pytest.raises(LayoutError):
        tflat.FlatParamSpace({})


def test_from_seed_writes_through_bucket_views():
    """`ServingWeights.from_seed` draws into the buckets through views: the
    tree shares the bucket storage, inits follow the ParamDefs, and the same
    seed gives the same weights."""
    cfg = TR.get_smoke_config(ARCH)
    sw = ServingWeights.from_seed(cfg, 5, device="cpu")
    again = ServingWeights.from_seed(cfg, 5, device="cpu")
    base = sw.bufs["float32"].untyped_storage().data_ptr()
    tree = sw.as_tree()
    for leaf in T.leaves(tree):
        assert leaf.untyped_storage().data_ptr() == base
    torch.testing.assert_close(sw.bufs["float32"], again.bufs["float32"],
                               rtol=0, atol=0)
    assert torch.all(tree["final_norm"]["scale"] == 1.0)
    assert torch.all(tree["layers"]["ln1"]["scale"] == 1.0)
    tok = tree["embed"]["tok"]
    assert abs(float(tok.std()) - 0.02) < 0.002
    wq = tree["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_rope_and_embed_match_jax():
    from repro.models import common as jcm
    x = np.random.default_rng(0).standard_normal((2, 1, 4, 64)).astype(
        np.float32)
    pos = np.asarray([[5], [1234]], np.int32)
    got = tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)
    jcfg, tcfg = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    tok = np.random.default_rng(1).standard_normal((8, 256)).astype(np.float32)
    ids = np.asarray([[3], [7]])
    got = tcm.embed_apply(tcfg, {"tok": torch.from_numpy(tok)},
                          torch.from_numpy(ids))
    want = jcm.embed_apply(jcfg, {"tok": jnp.asarray(tok)}, jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _teacher_forced(setup, n_steps, *, window_override=0, ragged=True):
    jcfg, tcfg, jp, npt = setup
    jmod, tmod = japi.get_module(jcfg), tapi.get_module(tcfg)
    tp = tpm.from_numpy_tree(npt, "cpu")
    b, max_len = 2, 48
    jc = jmod.init_cache(jcfg, b, max_len, dtype=jnp.float32,
                         window_override=window_override)
    tc = tmod.init_cache(tcfg, b, max_len, device="cpu",
                         window_override=window_override)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    ring = window_override > 0
    dec = jax.jit(lambda p, t, c, pos: jmod.decode_step(jcfg, p, t, c, pos,
                                                        ring=ring))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (n_steps, b))
    worst = 0.0
    for i in range(n_steps):
        pos = np.asarray([i, max(i - 5, 0)], np.int32) if ragged else \
            np.int32(i)
        jl, jc = dec(jp, jnp.asarray(toks[i], jnp.int32), jc,
                     jnp.asarray(pos))
        tl, tc = tmod.decode_step(tcfg, tp, torch.from_numpy(toks[i]), tc,
                                  torch.from_numpy(np.asarray(pos)) if ragged
                                  else int(pos), ring=ring)
        worst = max(worst, float(np.max(np.abs(np.asarray(jl) - tl.numpy()))))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    return worst


def test_decode_step_logits_match_jax_over_44_positions(setup):
    """Ragged per-slot positions, 44 teacher-forced steps: past position 32
    the smoke config's window (32, every other layer) masks old keys."""
    assert _teacher_forced(setup, 44) < LOGIT_TOL


def test_decode_step_ring_cache_matches_jax(setup):
    """Aligned scalar positions through a 16-row ring cache: 30 steps wrap
    it, and the keys carry absolute ring positions."""
    assert _teacher_forced(setup, 30, window_override=16,
                           ragged=False) < LOGIT_TOL


def test_cache_write_at_max_len_is_clamped(setup):
    """A lane at position max_len (a retired slot) writes row max_len-1, as
    JAX's dynamic_update_slice clamps it, instead of indexing out of range."""
    jcfg, tcfg, jp, npt = setup
    jmod, tmod = japi.get_module(jcfg), tapi.get_module(tcfg)
    tp = tpm.from_numpy_tree(npt, "cpu")
    max_len = 8
    jc = jmod.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    tc = tmod.init_cache(tcfg, 2, max_len, device="cpu")
    pos = np.asarray([max_len, 3], np.int32)
    tok = np.asarray([5, 9], np.int32)
    jl, jc = jmod.decode_step(jcfg, jp, jnp.asarray(tok), jc,
                              jnp.asarray(pos))
    tl, tc = tmod.decode_step(tcfg, tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert torch.any(tc["k"][:, 0, max_len - 1] != 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_zero_cache_slots_clears_only_those_lanes():
    cfg = TR.get_smoke_config(ARCH)
    cache = tapi.get_module(cfg).init_cache(cfg, 3, 4, device="cpu")
    for c in cache.values():
        c.fill_(1.0)
    tapi.zero_cache_slots(cache, [0, 2])
    for c in cache.values():
        assert torch.all(c[:, [0, 2]] == 0) and torch.all(c[:, 1] == 1)
