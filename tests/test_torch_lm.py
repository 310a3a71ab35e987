"""The port's LM path against the JAX package: the token stream, the dense
transformer's forward, loss and gradients (with a bidirectional prefix
too), prefill and one-shot generate,
QSR rounds of starcoder2-smoke and gemma3-smoke through the RoundEngine's
built-in token stream, and the training CLI for both.

Weights come from the JAX package's own init, carried across as numpy
(`from_numpy_tree`); token batches come from the two packages'
TokenStreams, which draw bitwise the same numbers.  Both packages compute
in fp32 and sum in different orders.  Tolerances, each with its reason:

* the token stream, the H trace and greedy tokens: equal.
* logits and the loss: 1e-5; every gradient leaf: 2e-5 (as the ViT's:
  fp32 sums in another order, observed ~1e-6).
* prefill: its logits 1e-5 and the cache it writes 1e-5.
* QSR rounds: per-round loss, grad norm and divergence within 2e-5
  relative (observed 2.2e-6).  AdamW's normalised step m / sqrt(v) is O(1)
  wherever a gradient element sits at the sum-order noise, so the final
  params are held per leaf to a relative L2 of 2e-4 (observed 1.6e-5) and
  every element to 2e-3 (observed 2.2e-4), as in `test_torch_train.py`.
* inside the port, tree and flat layouts: bitwise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import RunConfig as JRun
from repro.core import engine as jeng
from repro.core import schedules as jsched
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import param as jpm
from repro.models import transformer as jtf
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.core import flat as tflat
from repro_torch.core import schedules as tsched
from repro_torch.data import synthetic as tsyn
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import param as tpm
from repro_torch.models import transformer as ttf
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
GRAD_TOL = 2e-5
METRIC_TOL = 2e-5
PARAM_REL_TOL, PARAM_ABS_TOL = 2e-4, 2e-3
ARCHS = ("starcoder2-3b", "gemma3-4b")
W, B_LOC, SEQ = 2, 2, 16
# the training CLI's run config (launch/train.py main) at 12 steps
RUN = dict(schedule="qsr", optimizer="adamw", total_steps=12, peak_lr=3e-3,
           alpha=0.002, h_base=2, warmup_steps=1, remat=False)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = JR.get_smoke_config(request.param)
    tcfg = TR.get_smoke_config(request.param)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-12)


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_starcoder2_config_matches_the_jax_package(get):
    j, t = getattr(JR, get)("starcoder2-3b"), getattr(TR, get)("starcoder2-3b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tapi.get_module(t) is ttf
    assert tapi.batch_keys(t) == ("tokens",)
    want = 4096 if get == "get_config" else 64
    assert [t.layer_window(i) for i in range(t.n_layers)] == \
        [want] * t.n_layers == [j.layer_window(i) for i in range(j.n_layers)]


def test_starcoder2_param_tree_and_count_match():
    """Full width: layernorm scale and bias leaves, the tied embedding, and
    3,029,710,848 parameters (150,994,944 in the embedding, 95,956,992 per
    layer), at the same key paths and shapes as the JAX package's."""
    j, t = JR.get_config("starcoder2-3b"), TR.get_config("starcoder2-3b")
    jdefs = jax.tree_util.tree_flatten_with_path(
        jtf.param_defs(j), is_leaf=jpm.is_def)[0]
    tdefs = ttf.param_defs(t)
    assert [(jax.tree_util.keystr(p), d.shape, d.init) for p, d in jdefs] == \
        [(jax.tree_util.keystr(p), d.shape, d.init) for p, d in
         jax.tree_util.tree_flatten_with_path(tdefs, is_leaf=tpm.is_def)[0]]
    assert "head" not in tdefs["embed"] and "bias" in tdefs["final_norm"]
    assert tpm.count_params(tdefs) == jpm.count_params(jtf.param_defs(j)) \
        == 3_029_710_848
    assert tpm.count_params(tdefs["embed"]) == 150_994_944
    assert (tpm.count_params(tdefs["layers"]) // t.n_layers) == 95_956_992


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("step,worker,batch,seq",
                         [(0, 0, 2, 16), (17, 3, 5, 7), (4, 1, 1, 64)])
def test_token_stream_batches_are_bitwise_jax(step, worker, batch, seq):
    js, ts = jsyn.TokenStream(vocab=512, seed=3), \
        tsyn.TokenStream(vocab=512, seed=3)
    jt, jl = js.batch(step, worker, batch, seq)
    tt, tl = ts.batch(step, worker, batch, seq)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tt.dtype == tl.dtype == torch.int32
    cfg_j, cfg_t = JR.get_smoke_config("starcoder2-3b"), \
        TR.get_smoke_config("starcoder2-3b")
    jb = jsyn.make_train_batch(cfg_j, js, step, 3, batch, seq)
    tb = tsyn.make_train_batch(cfg_t, ts, step, 3, batch, seq)
    assert set(tb) == {"tokens", "labels"}
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_unported_batch_families_raise():
    """Named for what it pinned when audio batches raised.  An audio batch
    is the dense one with stub `frames` [W, B, enc_seq, D] beside it, and a
    vlm batch the dense one with the image prefix
    (`test_torch_dense_families.py` and `test_torch_whisper.py` hold their
    draws)."""
    ts = tsyn.TokenStream(vocab=16)
    base = TR.get_smoke_config("starcoder2-3b")
    audio = dataclasses.replace(base, family="audio", enc_seq=5)
    got = tsyn.make_train_batch(audio, ts, 0, 2, 2, 4)
    want = tsyn.make_train_batch(base, ts, 0, 2, 2, 4)
    assert set(got) == {"tokens", "labels", "frames"}
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["frames"].shape == (2, 2, 5, base.d_model)
    vlm = dataclasses.replace(base, family="vlm", n_img_tokens=3)
    got = tsyn.make_train_batch(vlm, ts, 0, 2, 2, 4)
    want = tsyn.make_train_batch(base, ts, 0, 2, 2, 4)
    assert set(got) == {"tokens", "labels", "prefix_embeds"}
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["prefix_embeds"].shape == (2, 2, 3, base.d_model)


# --------------------------------------------------- forward, loss, grad --

def test_lm_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jcm.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m))
        got = tcm.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if m is None else torch.from_numpy(m))
        _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(setup, remat):
    jcfg, tcfg, jp, npt = setup
    toks, labels = _tokens(tcfg, 2, SEQ)
    jlogits, jaux = jtf.forward(jcfg, jp, jnp.asarray(toks), remat=remat)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jbatch, remat=remat))(jp)

    tp = tpm.from_numpy_tree(npt, "cpu")
    leaves, treedef = T.flatten(tp)
    alias = [x.requires_grad_(True) for x in leaves]
    tp = T.unflatten(treedef, alias)
    tlogits, taux = ttf.forward(tcfg, tp, torch.from_numpy(toks), remat=remat)
    _close(tlogits.detach(), jlogits, LOGIT_TOL)
    assert float(taux) == float(jaux) == 0.0
    tloss = ttf.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)},
                        remat=remat)
    _close(tloss.detach(), jloss, LOGIT_TOL)
    tgrads = torch.autograd.grad(tloss, alias)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tgrads)
    for a, b in zip(jl, tgrads):
        _close(b, a, GRAD_TOL)
        assert float(np.abs(np.asarray(a)).max()) > 0.0


def test_remat_changes_nothing(setup):
    """Recomputing each layer in the backward gives the same bits."""
    _, tcfg, _, npt = setup
    toks, labels = _tokens(tcfg, 2, SEQ, seed=4)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    out = []
    for remat in (False, True):
        leaves, treedef = T.flatten(tpm.from_numpy_tree(npt, "cpu"))
        alias = [x.requires_grad_(True) for x in leaves]
        loss = ttf.loss_fn(tcfg, T.unflatten(treedef, alias), batch,
                           remat=remat)
        out.append([loss] + list(torch.autograd.grad(loss, alias)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_prefix_embeds_are_not_ported(setup):
    """(Named for what it pinned before the prefix was ported.)  The dense
    family takes a bidirectional prefix too, as the reference's forward
    and prefill do: the text positions' logits and the cache match the JAX
    package's."""
    jcfg, tcfg, jp, npt = setup
    tp = tpm.from_numpy_tree(npt, "cpu")
    toks, _ = _tokens(tcfg, 2, 6, seed=3)
    pre = (0.02 * np.random.default_rng(3).standard_normal(
        (2, 5, tcfg.d_model))).astype(np.float32)
    want, _ = jtf.forward(jcfg, jp, jnp.asarray(toks),
                          prefix_embeds=jnp.asarray(pre), remat=False)
    with torch.no_grad():
        got, _ = ttf.forward(tcfg, tp, torch.from_numpy(toks),
                             prefix_embeds=torch.from_numpy(pre),
                             remat=False)
    assert got.shape == (2, 6, tcfg.vocab)
    _close(got, want, LOGIT_TOL)
    jlog, jcache = jtf.prefill(
        jcfg, jp, jnp.asarray(toks),
        jtf.init_cache(jcfg, 2, 16, dtype=jnp.float32),
        prefix_embeds=jnp.asarray(pre))
    with torch.no_grad():
        tlog, tcache = ttf.prefill(
            tcfg, tp, torch.from_numpy(toks),
            ttf.init_cache(tcfg, 2, 16, device="cpu"),
            prefix_embeds=torch.from_numpy(pre))
    _close(tlog, jlog, LOGIT_TOL)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], LOGIT_TOL)


# ------------------------------------------------------ prefill, generate --

def test_prefill_logits_and_cache_match_jax(setup):
    jcfg, tcfg, jp, npt = setup
    toks, _ = _tokens(tcfg, 3, 11, seed=5)
    max_len = 24
    jlog, jcache = jtf.prefill(
        jcfg, jp, jnp.asarray(toks),
        jtf.init_cache(jcfg, 3, max_len, dtype=jnp.float32))
    cache = ttf.init_cache(tcfg, 3, max_len, device="cpu")
    with torch.no_grad():
        tlog, tcache = ttf.prefill(tcfg, tpm.from_numpy_tree(npt, "cpu"),
                                   torch.from_numpy(toks), cache)
    assert tcache is cache
    _close(tlog, jlog, LOGIT_TOL)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], LOGIT_TOL)
        assert not tcache[k][:, :, 11:].any()


def test_prefill_equals_feeding_the_prompt_through_decode(setup):
    """The port alone: the last position's logits of one full-sequence pass
    and of the prompt fed one token at a time through decode_step."""
    _, tcfg, _, npt = setup
    toks, _ = _tokens(tcfg, 2, 9, seed=6)
    tp = tpm.from_numpy_tree(npt, "cpu")
    with torch.no_grad():
        want, _ = ttf.prefill(tcfg, tp, torch.from_numpy(toks),
                              ttf.init_cache(tcfg, 2, 16, device="cpu"))
        cache = ttf.init_cache(tcfg, 2, 16, device="cpu")
        for i in range(toks.shape[1]):
            got, cache = ttf.decode_step(tcfg, tp,
                                         torch.from_numpy(toks[:, i]),
                                         cache, i)
    _close(got, want, LOGIT_TOL)


def test_generate_greedy_tokens_equal_jax(setup):
    jcfg, tcfg, jp, npt = setup
    prompts, _ = _tokens(tcfg, 3, 7, seed=7)
    want = jserve.generate(jcfg, jp, jnp.asarray(prompts), gen_len=8)
    ops.reset_launch_counts()
    got = tserve.generate(tcfg, tpm.from_numpy_tree(npt, "cpu"), prompts,
                          gen_len=8)
    assert got.dtype == torch.int32 and got.shape == (3, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(ops.launch_counts().values()) == {0}    # CPU: plain versions


def test_generate_samples_and_refuses_the_ring(setup):
    """Named for what it pinned when the ring cache raised.  Sampling is
    deterministic under a seed, on the full cache and on a ring window past
    its wrap (69 positions: past both smoke configs' ring caches, gemma3's
    32 rows and starcoder2's 64); a cache too short without a ring raises.
    `test_torch_serving.py` holds the ring's greedy tokens against the JAX
    package."""
    _, tcfg, _, npt = setup
    tp = tpm.from_numpy_tree(npt, "cpu")
    prompts, _ = _tokens(tcfg, 2, 5, seed=8)
    for kw in ({"gen_len": 6}, {"gen_len": 64, "window_override": 8}):
        a = tserve.generate(tcfg, tp, prompts, temperature=0.8, seed=3, **kw)
        b = tserve.generate(tcfg, tp, prompts, temperature=0.8, seed=3, **kw)
        assert torch.equal(a, b)
        assert torch.equal(a[:, :5], torch.from_numpy(prompts))
        assert int(a.max()) < tcfg.vocab and int(a.min()) >= 0
    with pytest.raises(ValueError, match="exceed the KV cache"):
        tserve.generate(tcfg, tp, prompts, gen_len=6, max_len=8)


def test_serve_cli_one_shot_generate():
    toks = tserve.main(["--smoke", "--device", "cpu", "--arch",
                        "starcoder2-3b", "--batch", "2", "--prompt-len", "5",
                        "--gen", "4"])
    assert toks.shape == (2, 9)
    cfg = TR.get_smoke_config("starcoder2-3b")
    params = tserve.W.ServingWeights.from_seed(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = np.stack([rng.integers(0, cfg.vocab, 5, dtype=np.int32)
                        for _ in range(2)])
    ring = tserve.main(["--smoke", "--device", "cpu", "--arch",
                        "starcoder2-3b", "--batch", "2", "--prompt-len", "5",
                        "--gen", "64", "--window", "8"])
    want = tserve.generate(cfg, params.as_tree(), prompts, gen_len=64,
                           window_override=8)
    assert torch.equal(ring, want)
    with pytest.raises(ConfigError, match="--window with --slots"):
        tserve.main(["--smoke", "--device", "cpu", "--slots", "2",
                     "--window", "8"])


# ----------------------------------------------------- QSR engine rounds --

def _jax_rounds(jcfg, jp, **run_kw):
    run = JRun(**{**RUN, **run_kw})
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


def _port_rounds(tcfg, npt, layout="tree", **run_kw):
    run = TRun(**{**RUN, **run_kw})
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", layout=layout, device="cpu")
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    lr_fn, t = tlr.make_lr_fn(run), 0
    while t < run.total_steps:
        h = tsched.get_h(run, t, lr_fn)
        state, _ = eng.run_round(state, t, h, lr_fn)
        t += h
    return eng, state


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg = JR.get_smoke_config(request.param)
    tcfg = TR.get_smoke_config(request.param)
    jp = jpm.init_params(jtf.param_defs(jcfg), jax.random.PRNGKey(1))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def test_engine_qsr_rounds_on_the_token_stream_match_jax(lm):
    jcfg, tcfg, jp, npt = lm
    j_trace, j_metrics, j_final = _jax_rounds(jcfg, jp)
    eng, state = _port_rounds(tcfg, npt)
    assert eng.h_trace == j_trace
    assert len(j_trace) >= 4 and len({h for _, h in j_trace}) >= 2
    assert eng.data_seconds > 0
    for jm, tm in zip(j_metrics, eng.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert _rel(jm[k], float(tm[k])) <= METRIC_TOL, (k, jm, tm)
    got = T.leaves(eng.params_single(state))
    for a, b in zip(jax.tree.leaves(j_final), got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= PARAM_REL_TOL * np.linalg.norm(a)
        assert np.abs(a - b).max() <= PARAM_ABS_TOL


def test_tree_and_flat_layouts_are_bitwise_equal_on_the_lm(lm):
    _, tcfg, _, npt = lm
    kw = dict(total_steps=6, sync_quantize=True)
    e_tree, s_tree = _port_rounds(tcfg, npt, "tree", **kw)
    e_flat, s_flat = _port_rounds(tcfg, npt, "flat", **kw)
    s_flat = tflat.to_tree_state(e_flat.spec, s_flat)
    lt, td_t = T.flatten(s_tree)
    lf, td_f = T.flatten(s_flat)
    assert td_t == td_f
    for a, b in zip(lt, lf):
        assert torch.equal(a, b)


def test_a_finished_runs_state_dies_at_del():
    """No reference cycle holds a finished run's state: once the caller
    drops the state and the engine, every leaf and the engine are gone
    without the garbage collector (a cycle through `tree.flatten`'s
    recursive closure once kept a whole training state, 48.5 GB of
    starcoder2-3b's on the card, until the collector ran; the engine kept
    itself through its batch lambda).  The first remat run of a process is
    `test_first_remat_run_of_a_process_dies_at_del`'s."""
    import gc
    import weakref
    cfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**{**RUN, "total_steps": 2})
    eng = teng.RoundEngine(cfg, run, workers=2, b_loc=1, seq=8, data="host",
                           device="cpu")
    gc.collect()
    gc.disable()
    try:
        state, _ = ttrain.train(cfg, run, workers=2, b_loc=1, seq=8,
                                data="host", eng=eng, device="cpu",
                                log_every=0)
        refs = [weakref.ref(x) for x in T.leaves(state)] + [
            weakref.ref(eng)]
        del state, eng
        assert len(refs) > 1 and all(r() is None for r in refs)
    finally:
        gc.enable()


FIRST_REMAT_RUN = """
import gc, weakref
from repro_torch import tree as T
from repro_torch.configs import registry as R
from repro_torch.configs.base import RunConfig
from repro_torch.core.engine import RoundEngine
from repro_torch.launch.train import train
import torch
torch.set_num_threads(1)
cfg = R.get_smoke_config("starcoder2-3b")
run = RunConfig(schedule="qsr", optimizer="adamw", total_steps=2,
                peak_lr=3e-3, alpha=0.002, h_base=2, warmup_steps=1,
                remat=True)
gc.collect()
gc.disable()
eng = RoundEngine(cfg, run, workers=2, b_loc=1, seq=8, data="host",
                  device="cpu")
state, _ = train(cfg, run, workers=2, b_loc=1, seq=8, data="host", eng=eng,
                 device="cpu", log_every=0)
refs = [weakref.ref(x) for x in T.leaves(state)]
engine = weakref.ref(eng)
del state, eng
print("ALIVE", len(refs), sum(r() is not None for r in refs),
      engine() is not None)
"""


def test_first_remat_run_of_a_process_dies_at_del():
    """The first remat run of a fresh process (an xdist worker may have
    imported torch._dynamo already, so a subprocess): with the collector
    off, no state leaf and not the engine outlive `del`.  The first
    `torch.utils.checkpoint` call imports torch._dynamo, and that import,
    made under the training frames, kept them (and the state in their
    locals) in a reference cycle until `core/local_update.py` imported it
    first."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", FIRST_REMAT_RUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ALIVE")]
    assert line, out.stdout[-2000:]
    _, leaves, alive, engine = line[-1].split()
    assert int(leaves) > 0 and (int(alive), engine) == (0, "False"), line


def test_serving_modules_leave_torch_dynamo_unloaded():
    """Only the training step imports torch._dynamo (for remat's sake):
    the modules a server loads leave it out, and a server does not pay for
    the import.  A subprocess, as an xdist worker may have imported it
    already."""
    import os
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.launch.batching\n"
            "import repro_torch.launch.weights, repro_torch.models.api\n"
            "print('DYNAMO', 'torch._dynamo' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DYNAMO False" in out.stdout, out.stdout[-2000:]


def test_engine_refuses_device_data_and_points_to_host():
    """Named for what it pinned when device data raised.  The engine's
    default `data="device"` now draws its batches on the engine's device
    (`device_batch_fn`) and trains; `tests/test_torch_device_data.py` holds
    the draws."""
    cfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**{**RUN, "total_steps": 4})
    eng = teng.RoundEngine(cfg, run, workers=2, b_loc=2, seq=8,
                           device="cpu")
    assert eng.data == "device"
    _, hist = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8, eng=eng,
                           log_every=0)
    assert hist[-1][0] == 4
    assert all(np.isfinite(loss) for _, _, loss, _ in hist)
    with pytest.raises(ConfigError, match="batch_fn is a host-data source"):
        teng.RoundEngine(cfg, run, workers=2, b_loc=2, seq=8,
                         batch_fn=lambda step: {}, device="cpu")


# ---------------------------------------------------------- training CLI --

CLI = ["--smoke", "--device", "cpu", "--steps", "8", "--workers", "2",
       "--batch", "2", "--seq", "8"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_equals_train(capsys, arch):
    _, hist = ttrain.main(["--arch", arch] + CLI)
    assert "final loss" in capsys.readouterr().out
    cfg = TR.get_smoke_config(arch)
    run = TRun(schedule="qsr", total_steps=8, peak_lr=3e-3, alpha=0.002,
               h_base=2, warmup_steps=1, remat=False)
    _, want = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8, data="host",
                           device="cpu", log_every=0)
    assert hist == want
    assert [h for _, h, _, _ in hist] == \
        [h for _, h in tsched.h_trace(run, tlr.make_lr_fn(run))]


@pytest.mark.parametrize("flags", [
    ["--mesh", "4x2"], ["--param-layout", "flat_sharded", "--mesh", "4x2"]])
def test_train_cli_unported_flags_raise(flags):
    """`--mesh` in one process: a mesh needs the flat_sharded layout, as the
    reference's does, and one process a rank (`multihost --spawn`), where
    the reference runs simulated devices in one process."""
    match = ("--spawn 8" if "flat_sharded" in flags
             else "needs --param-layout flat_sharded")
    with pytest.raises(ConfigError, match=match):
        ttrain.main(["--arch", "starcoder2-3b"] + CLI + flags)


@pytest.mark.parametrize("case", ["trace", "overlap-frontier", "legacy"])
def test_train_cli_adaptive_flags(case, tmp_path):
    """`--schedule adaptive` with `--controller-trace` writes a v1 trace of
    `--steps` steps; with `--sync overlap --frontier` (a table4 JSON) the
    controller chooses the depth; under `--engine legacy` the engine has
    no batch knob, so the lanes stay at `--batch`."""
    trace = str(tmp_path / "trace.json")
    flags = ["--schedule", "adaptive", "--controller-trace", trace]
    if case == "overlap-frontier":
        front = str(tmp_path / "f.json")
        with open(front, "w") as f:
            json.dump({"overlap": {"blocking_d0": {"s_per_round": 1.0},
                                   "overlap_d1": {"s_per_round": 0.5}}}, f)
        flags += ["--sync", "overlap", "--frontier", front]
    if case == "legacy":
        flags += ["--engine", "legacy"]
    _, hist = ttrain.main(["--arch", "starcoder2-3b"] + CLI + flags)
    with open(trace) as f:
        rec = json.load(f)
    assert rec["schema"] == "controller_trace/v1"
    assert rec["summary"]["steps"] == 8 == hist[-1][0]
    assert [r["h"] for r in rec["rounds"]] == [h for _, h, _, _ in hist]
    assert rec["adaptive_batch"] == (case != "legacy")
    assert rec["adaptive_depth"] == (case == "overlap-frontier")
    lanes = [r["batch_lanes"] for r in rec["rounds"]]
    assert lanes[0] == (2 if case == "legacy" else 1)
    if case == "overlap-frontier":
        assert rec["frontier"] == {"0": 1.0, "1": 0.5}

