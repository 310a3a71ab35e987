"""The port's ShardedFlatSpace (`--param-layout flat_sharded`) on one
process, against the JAX package's, and the bf16 plain versions of the two
sync kernels.

* The space itself, on the reference's mixed-dtype demo params (numpy
  draws, `launch/multihost.py _demo_params`): its padding, segment ids and
  buffers equal the JAX package's bitwise; the pad round-trips, and no
  per-tensor statistic sees it; the per-chunk reductions a mesh rank runs
  fold to the whole-bucket ones exactly (max is exact).
* The mesh-less `flat_sharded` engine (starcoder2-3b smoke, W = 2, 3
  rounds) is bitwise the flat engine in every sync mode: the pad elements
  start and stay zero.
* `sync_flat_update` / `sync_apply_update` plain versions on bf16 buckets
  bitwise against `repro/kernels/ref.py`, run op by op (the ops the
  CUDA kernels' bf16 instances are held to bitwise on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jflat
from repro.kernels import ref as jref
from repro.launch import multihost as jmh
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig
from repro_torch.core import flat as tflat
from repro_torch.core.engine import RoundEngine
from repro_torch.errors import ConfigError
from repro_torch.kernels import ref as tref
from repro_torch.launch import multihost as tmh
from repro_torch.launch import train as ttrain
from repro_torch.optim.lr import make_lr_fn
from torch_one_thread import one_torch_thread  # noqa: F401


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("shards", [1, 4, 8, 12])
def test_sharded_space_matches_reference_layout(shards):
    jp, tp = jmh._demo_params(0), tmh._demo_params(0)
    js, ts = jflat.ShardedFlatSpace(jp, shards), tflat.ShardedFlatSpace(
        tp, shards)
    assert ts.buckets == js.buckets
    jb, tb = js.flatten(jp), ts.flatten(tp)
    for b in js.buckets:
        assert ts.pad[b] == js.pad[b]
        assert ts.buffer_size(b) == js.buffer_size(b)
        assert ts.buffer_size(b) % shards == 0
        assert np.array_equal(ts.segment_ids(b), js.segment_ids(b))
        assert tb[b].shape == (ts.buffer_size(b),)
        assert np.array_equal(tb[b].float().numpy(), _np(jb[b]))


def test_sharded_space_pad_round_trip_and_statistics():
    tp = tmh._demo_params(0)
    ts = tflat.ShardedFlatSpace(tp, 7)           # pads both buckets
    stacked = T.map(lambda x: torch.stack([x, -x, 2 * x]), tp)
    bufs = ts.flatten(stacked, lead=1)
    for b, x in bufs.items():
        assert ts.pad[b] > 0
        assert torch.all(x[:, ts.sizes[b]:] == 0)
    back = ts.unflatten(bufs, lead=1)
    for k in tp:
        assert torch.equal(back[k], stacked[k])
    # a huge pad value never reaches a leaf's statistic; spread fills the
    # pad with the last leaf's
    for b, x in ts.flatten(tp).items():
        y = x.float().clone()
        y[ts.sizes[b]:] = 1e30
        per_leaf = ts.segment_max(b, y)
        want = torch.stack([tp[k].float().max() for k in sorted(tp)
                            if str(tp[k].dtype).endswith(b)])
        assert torch.equal(per_leaf, want)
        sp = ts.spread(b, per_leaf)
        assert sp.shape == (ts.buffer_size(b),)
        assert torch.all(sp[ts.sizes[b]:] == per_leaf[-1])


@pytest.mark.parametrize("n_chunks", [2, 4, 8])
def test_chunk_reductions_fold_to_the_whole(n_chunks):
    tp = tmh._demo_params(0)
    ts = tflat.ShardedFlatSpace(tp, 8)
    g = torch.Generator().manual_seed(3)
    for b in ts.buckets:
        n = ts.buffer_size(b)
        x = torch.rand(n, generator=g)
        c = n // n_chunks
        parts = torch.stack([ts.chunk_segment_max(b, x[i * c:(i + 1) * c],
                                                  i * c)
                             for i in range(n_chunks)])
        assert torch.equal(parts.amax(0), ts.segment_max(b, x))
        per_leaf = ts.segment_max(b, x)
        whole = ts.spread(b, per_leaf)
        for i in range(n_chunks):
            assert torch.equal(ts.chunk_spread(b, per_leaf, i * c,
                                               (i + 1) * c),
                               whole[i * c:(i + 1) * c])


def test_flat_state_slices_follow_the_chunk_rule():
    tp = tmh._demo_params(0)
    ts = tflat.ShardedFlatSpace(tp, 8)
    run = RunConfig(sync_quantize=True, outer_momentum=0.9)
    sl = tflat.flat_state_slices(run, ts, 1, 2, 4)
    for b in ts.buckets:
        c = ts.buffer_size(b) // 4
        assert sl["params"][b] == (slice(1, 2), slice(2 * c, 3 * c))
        assert sl["opt"]["m"][b] == sl["params"][b]
        assert sl["anchor"][b] == (slice(2 * c, 3 * c),)
        assert sl["outer_mu"][b] == (slice(2 * c, 3 * c),)
    assert sl["opt"]["step"] == ()
    sgd = tflat.flat_state_slices(RunConfig(optimizer="sgd"), ts, 0, 0, 2)
    assert set(sgd["opt"]) == {"mu", "step"} and "anchor" not in sgd


def test_take_slices_copies_each_slice_into_its_own_storage():
    """A rank's state owns its storage: no slice is a view at an offset
    into the whole state (the card's vector loads need the allocator's
    alignment, and a view would keep the whole state alive)."""
    ts = tflat.ShardedFlatSpace(tmh._demo_params(0), 3)
    gen = torch.Generator().manual_seed(0)
    rows = lambda: {b: torch.randn(3, ts.buffer_size(b), generator=gen)  # noqa: E731
                    for b in ts.buckets if ts.buffer_size(b)}
    whole = {"params": rows(), "opt": {"m": rows(), "v": rows(),
                                       "step": torch.tensor(5)},
             "anchor": {b: x[0] for b, x in rows().items()}}
    run = RunConfig(sync_quantize=True)
    for worker, shard, n_shards in ((1, 0, 1), (2, 1, 3)):
        sl = tflat.flat_state_slices(run, ts, worker, shard, n_shards)
        got = tflat.take_slices(whole, sl)
        assert got["opt"]["step"] is whole["opt"]["step"]
        for x, want, s in zip(T.leaves(got), T.leaves(whole), T.leaves(sl)):
            if not s:
                continue
            assert torch.equal(x, want[s]) and x.is_contiguous()
            assert x.storage_offset() == 0
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


# -------------------------------------------- the mesh-less flat_sharded --

SC2 = "starcoder2-3b"
MODES = {
    "blocking": dict(sync="blocking"),
    "overlap_d0": dict(sync="overlap", overlap_depth=0),
    "overlap_d1": dict(sync="overlap", overlap_depth=1),
    "partial": dict(sync="partial"),
    "ring": dict(sync="blocking", wire="ring-int8"),
}


def _run_engine(layout, mode):
    kw = dict(MODES[mode])
    wire = kw.pop("wire", "auto")
    cfg = TR.get_smoke_config(SC2)
    run = RunConfig(schedule="qsr", optimizer="adamw", total_steps=6,
                    peak_lr=3e-3, end_lr=1e-6, warmup_steps=1, h_base=2,
                    alpha=0.001, remat=False, weight_decay=0.01,
                    sync_quantize=True, sync_wire=wire)
    eng = RoundEngine(cfg, run, workers=2, b_loc=2, seq=16, data="host",
                      layout=layout, device="cpu", **kw)
    if mode == "partial":
        eng.membership_epoch([1.0, 0.0])
    lr_fn = make_lr_fn(run)
    state = eng.init_state()
    losses = []
    for t in (0, 2, 4):
        state, m = eng.run_round(state, t, 2, lr_fn)
        losses.append(float(m["loss"]))
    return eng, eng.flush(state), losses


@pytest.mark.parametrize("mode", list(MODES))
def test_flat_sharded_engine_is_bitwise_the_flat_engine(mode):
    e_flat, s_flat, l_flat = _run_engine("flat", mode)
    e_sh, s_sh, l_sh = _run_engine("flat_sharded", mode)
    assert isinstance(e_sh.spec, tflat.ShardedFlatSpace)
    assert e_sh.spec.shards == 2
    assert l_sh == l_flat
    for k in ("params", "anchor"):
        for b, x in s_flat[k].items():
            n = x.shape[-1]
            y = s_sh[k][b]
            assert torch.equal(y[..., :n], x), (k, b)
            assert torch.all(y[..., n:] == 0)
    for slot in ("m", "v"):
        for b, x in s_flat["opt"][slot].items():
            assert torch.equal(s_sh["opt"][slot][b][..., :x.shape[-1]], x)
    p_flat, p_sh = e_flat.params_single(s_flat), e_sh.params_single(s_sh)
    for a, b in zip(T.leaves(p_flat), T.leaves(p_sh)):
        assert torch.equal(a, b)


def test_flat_sharded_checkpoint_restores_into_the_flat_layout(tmp_path):
    eng, state, _ = _run_engine("flat_sharded", "blocking")
    eng.save(str(tmp_path / "ck"), state, step=6)
    flat_eng, flat_state, _ = _run_engine("flat", "blocking")
    like = flat_eng.init_state()
    got, step = flat_eng.restore(str(tmp_path / "ck"), like)
    assert step == 6
    for b, x in flat_state["params"].items():
        assert torch.equal(got["params"][b], x)


def test_train_cli_flat_sharded_and_mesh_alone(capsys):
    args = ["--arch", SC2, "--smoke", "--device", "cpu", "--steps", "4",
            "--workers", "2", "--batch", "2", "--seq", "16",
            "--param-layout", "flat_sharded"]
    state, hist = ttrain.main(args)
    assert len(hist) == 2 and all(np.isfinite(h[2]) for h in hist)
    with pytest.raises(ConfigError, match="--spawn 2"):
        ttrain.main(args + ["--mesh", "2x1"])
    with pytest.raises(ConfigError, match="flat_sharded"):
        ttrain.main(args[:-2] + ["--mesh", "2x1"])


# ------------------------------------------------ bf16 plain versions --

def _bf16_bucket(seed, w, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32) * 0.02
    p = (a[None] + rng.standard_normal((w, n)).astype(np.float32) * 1e-3)
    s = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32) * 3e-3
    mu = rng.standard_normal(n).astype(np.float32) * 1e-4
    q = np.clip(np.round(rng.standard_normal(n) * 40), -127, 127)
    return p, a, s, mu, (q / w).astype(np.float32)


def _pair(x, bf16):
    t = torch.from_numpy(np.ascontiguousarray(x))
    j = jnp.asarray(x)
    if bf16:
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _same(t, j):
    if t is None:
        return j is None
    assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
    return np.array_equal(t.float().numpy(), _np(j))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("w", [2, 4])
def test_bf16_sync_flat_update_plain_matches_reference(quantize, momentum, w):
    p, a, s, mu, _ = _bf16_bucket(w, w, 1000)
    tp, jp = _pair(p, True)
    ta, ja = _pair(a, True)
    kw_t = dict(scale=torch.from_numpy(s) if quantize else None,
                mu=torch.from_numpy(mu) if momentum else None,
                momentum=momentum)
    kw_j = dict(scale=jnp.asarray(s) if quantize else None,
                mu=jnp.asarray(mu) if momentum else None, momentum=momentum)
    got = tref.sync_flat_update(tp, ta, **kw_t)
    want = jref.sync_flat_update(jp, ja, **kw_j)
    for t, j in zip(got, want):
        assert _same(t, j)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_bf16_sync_apply_update_plain_matches_reference(quantize, momentum):
    _, a, s, mu, q = _bf16_bucket(7, 2, 1000)
    step = q if quantize else (np.random.default_rng(8).standard_normal(1000)
                               * 1e-3).astype(np.float32)
    ta, ja = _pair(a, True)
    kw_t = dict(scale=torch.from_numpy(s) if quantize else None,
                mu=torch.from_numpy(mu) if momentum else None,
                momentum=momentum)
    kw_j = dict(scale=jnp.asarray(s) if quantize else None,
                mu=jnp.asarray(mu) if momentum else None, momentum=momentum)
    got = tref.sync_apply_update(torch.from_numpy(step), ta, **kw_t)
    want = jref.sync_apply_update(jnp.asarray(step), ja, **kw_j)
    for t, j in zip(got, want):
        assert _same(t, j)


@pytest.mark.parametrize("layout", ["tree", "flat_sharded"])
def test_split_apply_at_one_lane_leaves_the_anchor_apart(layout):
    """The apply broadcasts the consensus into NEW params: at W = 1 an
    expanded view of the new anchor is contiguous, and params aliasing it
    would let the card's in-place optimizer move the anchor too."""
    from repro_torch.core.sync import make_sync_apply, make_sync_begin
    tp = tmh._demo_params(0)
    run = RunConfig(sync_quantize=True)
    spec = tflat.ShardedFlatSpace(tp, 4) if layout != "tree" else None
    params = T.map(lambda x: x[None].clone(), tp)
    state = {"params": params, "anchor": T.map(torch.clone, tp)}
    if spec is not None:
        state = {"params": spec.flatten(params, lead=1),
                 "anchor": spec.flatten(tp)}
    new = make_sync_apply(run, spec)(state, make_sync_begin(run, spec)(state))
    for p, a in zip(T.leaves(new["params"]), T.leaves(new["anchor"])):
        assert p.untyped_storage().data_ptr() != \
            a.untyped_storage().data_ptr()
        assert torch.equal(p[0], a)
