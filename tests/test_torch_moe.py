"""The port's MoE family (dbrx-132b, kimi-k2-1t-a32b) against the JAX
package: the MoE FFN's sort-based capacity dispatch, global and
shard-local, with and without a shared expert, at capacities that drop
nothing and that drop; both smoke models' forward, loss, aux loss and
gradients; greedy generate; the service loop; QSR rounds; both CLIs.

Weights come from the JAX package's own init, carried across as numpy
(`from_numpy_tree`); inputs are drawn with numpy.  The reference picks its
dispatch through module globals (`set_dispatch_shards`, `set_dispatch`);
every test here starts and ends with them at their defaults.  Tolerances
(fp32 sums in another order on each side):

* the MoE FFN's output 1e-6, its aux loss 1e-6 relative; a token whose
  every pick is dropped gives exactly 0 on both sides;
* logits and the loss 1e-5; every gradient leaf 2e-5; greedy tokens and
  the batcher's tokens equal;
* QSR rounds: per-round loss, grad norm and divergence within 2e-5
  relative; final params per leaf to a relative L2 of 2e-4 and every
  element to 2e-3 (`test_torch_dense_families.py`).  dbrx's untied `tok`
  embedding holds one element whose gradient sits at the sum-order noise:
  its AdamW steps take opposite signs in the two packages and it ends
  1.13e-3 (0.38 lr) apart (observed), which alone puts that small leaf
  (norm 5.1) at 2.2e-4 relative L2, every other leaf at most 1.2e-5.  So
  dbrx's leaves are held to 2e-3 relative L2, as qwen1.5-110b's are there
  for the same flip, and every element still to 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import RunConfig as JRun
from repro.core import engine as jeng
from repro.core import schedules as jsched
from repro.launch import batching as jbatching
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import param as jpm
from repro.models import transformer as jtf
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import ModelConfig as TModel
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.core import local_update as tlu
from repro_torch.core import schedules as tsched
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.batching import ContinuousBatcher, Request
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.models import param as tpm
from repro_torch.models import transformer as ttf
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

MOE_TOL = 1e-6
LOGIT_TOL = 1e-5
GRAD_TOL = 2e-5
ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")
W, B_LOC, SEQ = 2, 2, 16
RUN = dict(schedule="qsr", optimizer="adamw", total_steps=10, peak_lr=3e-3,
           alpha=0.002, h_base=2, warmup_steps=1, remat=False)
# QSR rounds' final params: each leaf's relative L2 (dbrx's after its
# AdamW flip: module docstring)
PARAM_REL_L2 = {"dbrx-132b": 2e-3, "kimi-k2-1t-a32b": 2e-4}


@pytest.fixture(autouse=True)
def reference_dispatch_at_defaults():
    """The reference's dispatch globals at their defaults before and after
    every test (files share a worker process)."""
    jmoe.set_dispatch_shards(1)
    jmoe.set_dispatch("auto", None)
    try:
        yield
    finally:
        jmoe.set_dispatch_shards(1)
        jmoe.set_dispatch("auto", None)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


# ------------------------------------------------------- the MoE FFN ------

def _ffn_cfgs(cf, shared=0, e=4, k=2):
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab=64, n_experts=e, top_k=k,
              capacity_factor=cf, n_shared_experts=shared)
    return JModel(**kw), TModel(**kw)


def _ffn(cf, shared=0, e=4, k=2, tokens=(2, 32), seed=0, port_only=False):
    """(jax cfg, port cfg, jax params, port params, x numpy [B,S,16]); with
    `port_only` the port's params drawn by its own init, and no JAX
    params."""
    jc, tc = _ffn_cfgs(cf, shared, e, k)
    if port_only:
        jp = None
        tp = tpm.init_params(tmoe.moe_defs(tc),
                             torch.Generator().manual_seed(seed))
    else:
        jp = jpm.init_params(jmoe.moe_defs(jc), jax.random.PRNGKey(seed))
        tp = tpm.from_numpy_tree(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        tokens + (16,)).astype(np.float32)
    return jc, tc, jp, tp, x


def _dropped_rows(out):
    return np.flatnonzero(np.all(np.asarray(out).reshape(-1, 16) == 0.0, -1))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_moe_apply_matches_jax(cf, shared):
    """Global dispatch; at 0.5 (and 1.0) the capacity drops picks, and
    without a shared expert the tokens that lose every pick are exactly 0
    on both sides."""
    jc, tc, jp, tp, x = _ffn(cf, shared, tokens=(4, 32))
    jo, ja = jmoe.moe_apply(jc, jp, jnp.asarray(x))
    to, ta = tmoe.moe_apply(tc, tp, torch.from_numpy(x))
    _close(to, jo, MOE_TOL)
    assert _rel(float(ja), float(ta)) <= MOE_TOL
    np.testing.assert_array_equal(_dropped_rows(to), _dropped_rows(jo))
    if cf == 0.5 and not shared:
        assert len(_dropped_rows(jo)) > 0         # the case is exercised
    if cf == 8.0:
        assert len(_dropped_rows(jo)) == 0


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_local_dispatch_matches_jax(shards, cf):
    """The shard-local dispatch (per-shard capacity) against the reference's
    `set_dispatch_shards`, with the shared expert; at 0.5 it drops other
    picks than the global dispatch does."""
    jc, tc, jp, tp, x = _ffn(cf, shared=1, tokens=(4, 32))
    try:
        jmoe.set_dispatch_shards(shards)
        jo, ja = jmoe.moe_apply(jc, jp, jnp.asarray(x))
    finally:
        jmoe.set_dispatch_shards(1)
    to, ta = tmoe.moe_apply(tc, tp, torch.from_numpy(x), shards=shards)
    _close(to, jo, MOE_TOL)
    assert _rel(float(ja), float(ta)) <= MOE_TOL
    glob, _ = tmoe.moe_apply(tc, tp, torch.from_numpy(x))
    if cf == 0.5:
        assert not torch.equal(glob, to)
    # shards that do not divide the tokens: the global dispatch, as the
    # reference's
    x3 = np.ascontiguousarray(x[:3, :29])          # 87 tokens
    odd, _ = tmoe.moe_apply(tc, tp, torch.from_numpy(x3), shards=4)
    assert torch.equal(odd, tmoe.moe_apply(tc, tp, torch.from_numpy(x3))[0])


def _dense_mixture(tc, tp, x):
    """Every expert on every token, mixed by the renormalized top-k
    probabilities: the no-drop oracle (float64)."""
    t = torch.from_numpy(x).double().reshape(-1, tc.d_model)
    p = {k: v.double() for k, v in tp.items() if k != "shared"}
    probs = torch.softmax(t @ p["router"], -1)
    tp_, ti = torch.topk(probs, tc.top_k, -1)
    tp_ = tp_ / tp_.sum(-1, keepdim=True)
    hidden = torch.nn.functional.silu(torch.einsum("td,edf->tef", t, p["wg"])) \
        * torch.einsum("td,edf->tef", t, p["wi"])
    expert_out = torch.einsum("tef,efd->ted", hidden, p["wo"])
    picked = torch.gather(expert_out, 1, ti[..., None].expand(
        -1, -1, tc.d_model))
    return torch.sum(picked * tp_[..., None], 1)


@pytest.mark.parametrize("case", [
    "no_drop_equals_dense_mixture", "drops_stay_finite_and_bounded",
    *(f"renormalized_e{e}_k{k}_t{t}" for e in (2, 4, 8) for k in (1, 2)
      for t in (16, 64))])
def test_moe_properties(case):
    """The port's counterparts of the JAX package's MoE property tests:
    with capacity to spare the dispatch is the dense mixture; with tight
    capacity the output stays finite and no larger than the no-drop one's
    largest row; and the k probabilities are renormalized (identical
    experts give one expert's output)."""
    if case == "no_drop_equals_dense_mixture":
        _, tc, _, tp, x = _ffn(8.0, tokens=(2, 8), port_only=True)
        out, aux = tmoe.moe_apply(tc, tp, torch.from_numpy(x))
        _close(out.reshape(-1, 16), _dense_mixture(tc, tp, x), 1e-5)
        assert float(aux) > 0.0
    elif case == "drops_stay_finite_and_bounded":
        _, tc, _, tp, x = _ffn(0.5, tokens=(2, 32), port_only=True)
        out, aux = tmoe.moe_apply(tc, tp, torch.from_numpy(x))
        full, _ = tmoe.moe_apply(dataclasses.replace(tc, capacity_factor=8.0),
                                 tp, torch.from_numpy(x))
        assert torch.isfinite(out).all() and torch.isfinite(aux)
        assert float(out.norm()) < float(full.norm())
    else:
        e, k, t = (int(v[1:]) for v in case.split("_")[1:])
        _, tc, _, tp, x = _ffn(8.0, e=e, k=k, tokens=(1, t), seed=e * k,
                               port_only=True)
        for name in ("wi", "wg", "wo"):
            tp[name] = tp[name][:1].expand_as(tp[name]).contiguous()
        out, aux = tmoe.moe_apply(tc, tp, torch.from_numpy(x))
        one = dataclasses.replace(tc, n_experts=1, top_k=1)
        p1 = {**tp, "router": tp["router"][:, :1]}
        p1.update({n: tp[n][:1] for n in ("wi", "wg", "wo")})
        want, _ = tmoe.moe_apply(one, p1, torch.from_numpy(x))
        assert out.shape == (1, t, 16) and torch.isfinite(aux)
        _close(out, want, 1e-6)


def test_shard_map_dispatch_raises():
    cfg = TR.get_smoke_config("dbrx-132b")
    with pytest.raises(ConfigError, match="shard_map.*not ported yet"):
        tlu.make_loss(cfg, TRun(moe_dispatch="shard_map"))
    with pytest.raises(ConfigError, match="unknown moe_dispatch"):
        tlu.make_loss(cfg, TRun(moe_dispatch="nope"))


# ------------------------------------------------- configs and params -----

@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_tree_match_the_jax_package(arch, get):
    j, t = getattr(JR, get)(arch), getattr(TR, get)(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jl = jax.tree.leaves(japi.get_module(j).param_defs(j), is_leaf=jpm.is_def)
    tl = T.leaves(tapi.get_module(t).param_defs(t))
    assert [(d.shape, d.axes, d.init, d.scale) for d in jl] == \
        [(d.shape, d.axes, d.init, d.scale) for d in tl]


def test_full_config_counts():
    """The parameter counts the card's phases are sized from: dbrx at 4 of
    its 40 layers (57.1 GB of fp32 weights) and 1; kimi at 1 of its 61
    layers with 128 and 16 of its 384 experts."""
    def count(arch, **cut):
        cfg = dataclasses.replace(TR.get_config(arch), **cut)
        return tpm.count_params(ttf.param_defs(cfg))
    assert count("dbrx-132b") == 131_597_021_184
    assert count("dbrx-132b", n_layers=4) == 14_269_526_016
    assert count("dbrx-132b", n_layers=1) == 4_492_234_752
    assert count("kimi-k2-1t-a32b", n_layers=1, n_experts=128) == \
        8_163_054_592
    assert count("kimi-k2-1t-a32b", n_layers=1, n_experts=16) == \
        3_229_750_272


# ------------------------------------------------- the smoke models -------

def _params(arch, key, **cut):
    jcfg = dataclasses.replace(JR.get_smoke_config(arch), **cut)
    tcfg = dataclasses.replace(TR.get_smoke_config(arch), **cut)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(key))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _params(request.param, 0)


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_aux_and_grads_match_jax(setup, remat):
    """The aux loss summed over the layers, in the loss at
    router_aux_coef; the router's gradient takes both its paths (the mean
    probability and the top-k weights)."""
    jcfg, tcfg, jp, npt = setup
    toks, labels = _tokens(tcfg, 2, SEQ)
    jlogits, jaux = jtf.forward(jcfg, jp, jnp.asarray(toks), remat=remat)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jbatch, remat=remat))(jp)

    leaves, treedef = T.flatten(tpm.from_numpy_tree(npt, "cpu"))
    alias = [x.requires_grad_(True) for x in leaves]
    tp = T.unflatten(treedef, alias)
    tlogits, taux = ttf.forward(tcfg, tp, torch.from_numpy(toks), remat=remat)
    _close(tlogits.detach(), jlogits, LOGIT_TOL)
    assert float(jaux) > 0.0
    assert _rel(float(jaux), float(taux.detach())) <= LOGIT_TOL
    tloss = ttf.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)},
                        remat=remat)
    _close(tloss.detach(), jloss, LOGIT_TOL)
    tgrads = torch.autograd.grad(tloss, alias)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tgrads)
    for a, b in zip(jl, tgrads):
        _close(b, a, GRAD_TOL)
    router = T.leaves(tp["layers"]["moe"]["router"])
    assert len(router) == 1


def test_generate_greedy_tokens_equal_jax(setup):
    """Prefill (16 tokens a prompt: capacity 16 at kimi-smoke's 8.0) and
    greedy decode steps."""
    jcfg, tcfg, jp, npt = setup
    prompts, _ = _tokens(tcfg, 3, 7, seed=7)
    want = jserve.generate(jcfg, jp, jnp.asarray(prompts), gen_len=8)
    ops.reset_launch_counts()
    got = tserve.generate(tcfg, tpm.from_numpy_tree(npt, "cpu"), prompts,
                          gen_len=8)
    assert got.dtype == torch.int32 and got.shape == (3, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(ops.launch_counts().values()) == {0}    # CPU: plain versions


@pytest.mark.parametrize("slots", [3, 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_service_loop_equals_jax_batcher_at_tight_capacity(arch, slots):
    """The --slots loop at capacity factor 0.5: every lane's token (a
    retired lane's too) takes capacity; at 12 slots (12 tokens a step
    against a capacity of 8) lanes drop each other's picks, the same ones
    on both sides."""
    jcfg, tcfg, jp, npt = _params(arch, 2, capacity_factor=0.5)
    prompts = [np.random.default_rng(i).integers(0, 512, n).astype(np.int32)
               for i, n in enumerate((5, 9, 7, 4, 6, 8, 3, 5, 9, 7, 6, 4,
                                      5, 8))]
    b = ContinuousBatcher(tcfg, tpm.from_numpy_tree(npt, "cpu"), slots=slots,
                          max_len=24, device="cpu")
    got = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    for r in got:
        b.submit(r)
    b.run()
    jb = jbatching.ContinuousBatcher(jcfg, jp, slots=slots, max_len=24)
    want = [jbatching.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in want:
        jb.submit(r)
    jb.run()
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]


# ----------------------------------------------------- QSR engine rounds --

def _jax_rounds(jcfg, jp, run):
    eng = jeng.RoundEngine(jcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host")
    state = eng.init_state(jp)
    lr_fn, t, metrics = jlr.make_lr_fn(run), 0, []
    while t < run.total_steps:
        h = jsched.get_h(run, t, lr_fn)
        state, m = eng.run_round(state, t, h, lr_fn)
        metrics.append({k: float(v) for k, v in m.items()})
        t += h
    return eng.h_trace, metrics, jax.tree.map(np.asarray,
                                               eng.params_single(state))


def _port_rounds(tcfg, npt, run):
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", device="cpu")
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    lr_fn, t = tlr.make_lr_fn(run), 0
    while t < run.total_steps:
        h = tsched.get_h(run, t, lr_fn)
        state, _ = eng.run_round(state, t, h, lr_fn)
        t += h
    return eng, state


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_five_qsr_rounds_match_jax(arch, shards):
    """Five rounds of Local AdamW under QSR from the reference's params, the
    router's aux loss in the objective, with the run's
    `moe_dispatch_shards` (the reference's set by its `make_loss`)."""
    jcfg, tcfg, jp, npt = _params(arch, 1)
    try:
        j_trace, j_metrics, j_final = _jax_rounds(
            jcfg, jp, JRun(**RUN, moe_dispatch_shards=shards))
    finally:
        jmoe.set_dispatch_shards(1)
    eng, state = _port_rounds(tcfg, npt,
                              TRun(**RUN, moe_dispatch_shards=shards))
    assert eng.h_trace == j_trace and len(j_trace) == 5
    for jm, tm in zip(j_metrics, eng.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert _rel(jm[k], float(tm[k])) <= 2e-5, (k, jm, tm)
    got = T.leaves(eng.params_single(state))
    for a, b in zip(jax.tree.leaves(j_final), got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= PARAM_REL_L2[arch] * np.linalg.norm(a)
        assert np.abs(a - b).max() <= 2e-3


# ------------------------------------------------------------------ CLIs --

@pytest.mark.parametrize("slots", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, slots):
    """One-shot (the tokens `generate`'s on the CLI's weights and prompts)
    and the --slots loop, on the CPU's plain versions."""
    ops.reset_launch_counts()
    argv = ["--smoke", "--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "5", "--gen", "4"]
    if slots:
        audit = tserve.main(argv + ["--slots", str(slots)])
        assert audit["tokens_emitted"] == 8
        return
    toks = tserve.main(argv)
    assert toks.shape == (2, 9)
    assert set(ops.launch_counts().values()) == {0}
    cfg = TR.get_smoke_config(arch)
    params = tserve.W.ServingWeights.from_seed(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = np.stack([rng.integers(0, cfg.vocab, 5, dtype=np.int32)
                        for _ in range(2)])
    assert torch.equal(toks, tserve.generate(cfg, params.as_tree(), prompts,
                                             gen_len=4))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_equals_train(capsys, arch):
    _, hist = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "6", "--workers", "2", "--batch", "2",
                           "--seq", "8"])
    assert "final loss" in capsys.readouterr().out
    cfg = TR.get_smoke_config(arch)
    run = TRun(schedule="qsr", total_steps=6, peak_lr=3e-3, alpha=0.002,
               h_base=2, warmup_steps=1, remat=False)
    _, want = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8, data="host",
                           device="cpu", log_every=0)
    assert hist == want
    assert all(np.isfinite(loss) for _, _, loss, _ in hist)


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_refuse_to_run_without_a_card_unasked(arch, monkeypatch):
    """No card and no --device cpu: both CLIs raise, as every entry point
    does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tserve.main(["--smoke", "--arch", arch, "--batch", "1"])
    with pytest.raises(ConfigError, match="no CUDA device"):
        ttrain.main(["--arch", arch, "--smoke", "--steps", "2"])
