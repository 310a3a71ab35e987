"""The port's whisper-base (the `audio` family: an encoder over stub frame
embeddings, a causal decoder with cross-attention on the encoder's output)
against the JAX package at its smoke config: config, parameter tree,
encode, forward, loss and gradients, prefill and its cache, generate, QSR
rounds and both CLIs.

Weights come from the JAX package's own init, carried across as numpy
(`from_numpy_tree`); the stub frames are one numpy array handed to both;
token batches come from the two packages' TokenStreams, which draw bitwise
the same numbers.  Tolerances as in `test_torch_lm.py` (fp32 sums in
another order on each side):

* configs, parameter trees, the H trace and greedy tokens: equal.
* encode, logits and the loss 1e-5; every gradient leaf 2e-5; prefill's
  logits and cache 1e-5; prefill against the prompt fed through decode
  1e-5.
* QSR rounds: per-round loss, grad norm and divergence within 2e-5
  relative; final params per leaf to a relative L2 of 2e-4 and every
  element to 2e-3 (AdamW's m / sqrt(v) is O(1) where a gradient sits at
  the sum-order noise).
"""
import dataclasses

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
from repro.models import param as jpm
from repro.models import whisper as jw
from repro.optim import lr as jlr
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.core import schedules as tsched
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch import weights as W
from repro_torch.models import api as tapi
from repro_torch.models import param as tpm
from repro_torch.models import whisper as tw
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "whisper-base"
LOGIT_TOL = 1e-5
GRAD_TOL = 2e-5
W_, B_LOC, SEQ = 2, 2, 16
# the training CLI's run config (launch/train.py main) at 10 steps: five
# rounds of H = 2
RUN = dict(schedule="qsr", optimizer="adamw", total_steps=10, peak_lr=3e-3,
           alpha=0.002, h_base=2, warmup_steps=1, remat=False)


def _params(key):
    jcfg, tcfg = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    jp = jpm.init_params(jw.param_defs(jcfg), jax.random.PRNGKey(key))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def setup():
    return _params(0)


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


def _frames(cfg, *lead, seed=0):
    """Stub frame embeddings [*lead, enc_seq, D] (numpy fp32, 0.1 · normal,
    the reference's scale)."""
    rng = np.random.default_rng(seed + 50)
    return (0.1 * rng.standard_normal(
        (*lead, cfg.enc_seq, cfg.d_model))).astype(np.float32)


# ------------------------------------------------------- configs, params --

@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_matches_the_jax_package(get):
    j, t = getattr(JR, get)(ARCH), getattr(TR, get)(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tapi.get_module(t) is tw


def test_param_tree_and_count_match():
    """Every ParamDef of the stacked encoder and decoder trees equal, full
    config and smoke, and the counts; `from_numpy_tree` carries every
    leaf."""
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(JR, get)(ARCH), getattr(TR, get)(ARCH)
        jdefs = japi.get_module(jc).param_defs(jc)
        tdefs = tapi.get_module(tc).param_defs(tc)
        jl = jax.tree.leaves(jdefs, is_leaf=jpm.is_def)
        tl = T.leaves(tdefs)
        assert [(d.shape, d.axes, d.init, d.scale) for d in jl] == \
            [(d.shape, d.axes, d.init, d.scale) for d in tl]
        assert tpm.count_params(tdefs) == jpm.count_params(jdefs)
    assert tpm.count_params(tw.param_defs(TR.get_config(ARCH))) == 70_627_840
    _, _, _, npt = _params(0)
    tp = tpm.from_numpy_tree(npt, "cpu")
    assert set(tp) == {"embed", "enc_layers", "enc_norm", "dec_layers",
                       "final_norm"}
    for a, b in zip(jax.tree.leaves(npt), T.leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a)


# ------------------------------------------- encode, forward, loss, grad --

def test_encode_matches_jax(setup):
    jcfg, tcfg, jp, npt = setup
    fr = _frames(tcfg, 2)
    want = jw.encode(jcfg, jp, jnp.asarray(fr))
    tp = tpm.from_numpy_tree(npt, "cpu")
    for remat in (False, True):
        got = tw.encode(tcfg, tp, torch.from_numpy(fr), remat=remat)
        assert got.shape == (2, tcfg.enc_seq, tcfg.d_model)
        _close(got.detach(), want, LOGIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(setup, remat):
    jcfg, tcfg, jp, npt = setup
    toks, labels = _tokens(tcfg, 2, SEQ)
    fr = _frames(tcfg, 2)
    jlogits, _ = jw.forward(jcfg, jp, jnp.asarray(toks),
                            frames=jnp.asarray(fr), remat=remat)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "frames": jnp.asarray(fr)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jw.loss_fn(jcfg, p, jbatch, remat=remat))(jp)

    leaves, treedef = T.flatten(tpm.from_numpy_tree(npt, "cpu"))
    alias = [x.requires_grad_(True) for x in leaves]
    tp = T.unflatten(treedef, alias)
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels),
              "frames": torch.from_numpy(fr)}
    tlogits, taux = tw.forward(tcfg, tp, tbatch["tokens"],
                               frames=tbatch["frames"], remat=remat)
    assert tlogits.shape == (2, SEQ, tcfg.vocab)
    _close(tlogits.detach(), jlogits, LOGIT_TOL)
    assert float(taux) == 0.0
    tloss = tw.loss_fn(tcfg, tp, tbatch, remat=remat)
    _close(tloss.detach(), jloss, LOGIT_TOL)
    tgrads = torch.autograd.grad(tloss, alias)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(tgrads)
    for a, b in zip(jl, tgrads):
        _close(b, a, GRAD_TOL)
        assert float(np.abs(np.asarray(a)).max()) > 0.0


# ------------------------------------------------------ prefill, generate --

def test_prefill_logits_and_cache_match_jax(setup):
    jcfg, tcfg, jp, npt = setup
    toks, _ = _tokens(tcfg, 3, 11, seed=5)
    fr = _frames(tcfg, 3, seed=5)
    jlog, jcache = jw.prefill(
        jcfg, jp, jnp.asarray(toks),
        jw.init_cache(jcfg, 3, 24, dtype=jnp.float32),
        frames=jnp.asarray(fr))
    cache = tw.init_cache(tcfg, 3, 24, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (2, 3, 24, 4, 32), "v": (2, 3, 24, 4, 32),
        "memory": (3, tcfg.enc_seq, tcfg.d_model)}
    tp = tpm.from_numpy_tree(npt, "cpu")
    with torch.no_grad():
        tlog, tcache = tw.prefill(tcfg, tp, torch.from_numpy(toks), cache,
                                  frames=torch.from_numpy(fr))
    assert tcache is cache
    _close(tlog, jlog, LOGIT_TOL)
    for k in ("k", "v", "memory"):
        _close(tcache[k], jcache[k], LOGIT_TOL)
    assert not tcache["k"][:, :, 11:].any()
    # without frames the prefill reads the memory already in the cache
    with torch.no_grad():
        again, _ = tw.prefill(tcfg, tp, torch.from_numpy(toks), cache)
    _close(again, tlog, 0.0)


def test_prefill_equals_feeding_the_prompt_through_decode(setup):
    """The port alone: the last position's logits of one full-sequence pass
    and of the frames and first token prefilled and the rest of the prompt
    fed one token at a time through decode_step."""
    _, tcfg, _, npt = setup
    toks, _ = _tokens(tcfg, 2, 9, seed=6)
    fr = torch.from_numpy(_frames(tcfg, 2, seed=6))
    tp = tpm.from_numpy_tree(npt, "cpu")
    with torch.no_grad():
        want, _ = tw.prefill(tcfg, tp, torch.from_numpy(toks),
                             tw.init_cache(tcfg, 2, 16, device="cpu"),
                             frames=fr)
        cache = tw.init_cache(tcfg, 2, 16, device="cpu")
        _, cache = tw.prefill(tcfg, tp, torch.from_numpy(toks[:, :1]), cache,
                              frames=fr)
        for i in range(1, toks.shape[1]):
            got, cache = tw.decode_step(tcfg, tp,
                                        torch.from_numpy(toks[:, i]), cache,
                                        i, prefix_len=7)
    _close(got, want, LOGIT_TOL)


def test_generate_greedy_tokens_equal_jax(setup):
    jcfg, tcfg, jp, npt = setup
    prompts, _ = _tokens(tcfg, 3, 7, seed=7)
    fr = _frames(tcfg, 3, seed=7)
    want = jserve.generate(jcfg, jp, jnp.asarray(prompts), gen_len=8,
                           extra={"frames": jnp.asarray(fr)})
    ops.reset_launch_counts()
    got = tserve.generate(tcfg, tpm.from_numpy_tree(npt, "cpu"), prompts,
                          gen_len=8, extra={"frames": fr})
    assert got.dtype == torch.int32 and got.shape == (3, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(ops.launch_counts().values()) == {0}    # CPU: plain versions
    # the frames matter: other frames give other tokens
    other = tserve.generate(tcfg, tpm.from_numpy_tree(npt, "cpu"), prompts,
                            gen_len=8, extra={"frames": 3 * fr})
    assert not torch.equal(other, got)


# ----------------------------------------------------- QSR engine rounds --

def _frame_batches(cfg, steps, seed=3):
    """Per-step stub frames [steps, W, B_LOC, enc_seq, D] from one numpy
    array, so that both engines see the same bits."""
    return _frames(cfg, steps, W_, B_LOC, seed=seed)


def _jax_rounds(jcfg, jp):
    run = JRun(**RUN)
    stream, fr = jsyn.TokenStream(vocab=jcfg.vocab), _frame_batches(
        jcfg, run.total_steps)

    def batch_fn(step):
        b = jsyn.make_train_batch(dataclasses.replace(jcfg, family="dense"),
                                  stream, step, W_, B_LOC, SEQ)
        return {**b, "frames": jnp.asarray(fr[step])}
    eng = jeng.RoundEngine(jcfg, run, workers=W_, b_loc=B_LOC, seq=SEQ,
                           data="host", batch_fn=batch_fn)
    state = eng.init_state(jp)
    lr_fn, t, metrics = jlr.make_lr_fn(run), 0, []
    while t < run.total_steps:
        h = jsched.get_h(run, t, lr_fn)
        state, m = eng.run_round(state, t, h, lr_fn)
        metrics.append({k: float(v) for k, v in m.items()})
        t += h
    return eng.h_trace, metrics, jax.tree.map(np.asarray,
                                               eng.params_single(state))


def _port_rounds(tcfg, npt, layout="tree"):
    run = TRun(**RUN)
    stream, fr = tsyn.TokenStream(vocab=tcfg.vocab), _frame_batches(
        tcfg, run.total_steps)

    def batch_fn(step):
        toks, labels = zip(*[stream.batch(step, k, B_LOC, SEQ)
                             for k in range(W_)])
        return {"tokens": torch.stack(toks), "labels": torch.stack(labels),
                "frames": torch.from_numpy(fr[step])}
    eng = teng.RoundEngine(tcfg, run, workers=W_, b_loc=B_LOC, seq=SEQ,
                           data="host", batch_fn=batch_fn, layout=layout,
                           device="cpu")
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    lr_fn, t = tlr.make_lr_fn(run), 0
    while t < run.total_steps:          # train()'s loop, from given params
        h = tsched.get_h(run, t, lr_fn)
        state, _ = eng.run_round(state, t, h, lr_fn)
        t += h
    return eng, state


def test_engine_five_qsr_rounds_match_jax():
    jcfg, tcfg, jp, npt = _params(1)
    j_trace, j_metrics, j_final = _jax_rounds(jcfg, jp)
    eng, state = _port_rounds(tcfg, npt)
    assert eng.h_trace == j_trace and len(j_trace) == 5
    for jm, tm in zip(j_metrics, eng.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert _rel(jm[k], float(tm[k])) <= 2e-5, (k, jm, tm)
    got = T.leaves(eng.params_single(state))
    for a, b in zip(jax.tree.leaves(j_final), got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= 2e-4 * np.linalg.norm(a)
        assert np.abs(a - b).max() <= 2e-3


def test_tree_and_flat_layouts_are_bitwise_equal():
    _, tcfg, _, npt = _params(1)
    tree_eng, tree_state = _port_rounds(tcfg, npt)
    flat_eng, flat_state = _port_rounds(tcfg, npt, layout="flat")
    for a, b in zip(T.leaves(tree_eng.params_single(tree_state)),
                    T.leaves(flat_eng.params_single(flat_state))):
        assert torch.equal(a, b)


# ------------------------------------------------------ audio batches, CLIs --

def test_audio_train_batches_carry_frames():
    """The port's own draw (not the reference's bits): [W, B, enc_seq, D]
    fp32, 0.1 · normal, a function of the step alone; the tokens are the
    dense batch's."""
    cfg = TR.get_smoke_config(ARCH)
    stream = tsyn.TokenStream(vocab=cfg.vocab)
    a = tsyn.make_train_batch(cfg, stream, 3, 2, 4, 8)
    assert set(a) == {"tokens", "labels", "frames"}
    fr = a["frames"]
    assert fr.dtype == torch.float32
    assert fr.shape == (2, 4, cfg.enc_seq, cfg.d_model)
    assert abs(float(fr.std()) - 0.1) < 0.005 and abs(float(fr.mean())) < 0.005
    again = tsyn.make_train_batch(cfg, tsyn.TokenStream(vocab=cfg.vocab), 3,
                                  2, 4, 8)
    assert all(torch.equal(a[k], again[k]) for k in a)
    other = tsyn.make_train_batch(cfg, stream, 4, 2, 4, 8)
    assert not torch.equal(other["frames"], fr)
    dense = tsyn.make_train_batch(dataclasses.replace(cfg, family="dense"),
                                  stream, 3, 2, 4, 8)
    assert torch.equal(dense["tokens"], a["tokens"])
    assert torch.equal(dense["labels"], a["labels"])


def test_serve_cli_one_shot_generate_with_stub_frames():
    ops.reset_launch_counts()
    toks = tserve.main(["--smoke", "--device", "cpu", "--arch", ARCH,
                        "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert toks.shape == (2, 9)
    assert set(ops.launch_counts().values()) == {0}
    cfg = TR.get_smoke_config(ARCH)
    params = W.ServingWeights.from_seed(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = np.stack([rng.integers(0, cfg.vocab, 5, dtype=np.int32)
                        for _ in range(2)])
    extra = tserve.audio_frames(cfg, 2, "cpu")
    assert extra["frames"].shape == (2, cfg.enc_seq, cfg.d_model)
    assert tserve.image_prefix(cfg, 2, "cpu") == {}
    want = tserve.generate(cfg, params.as_tree(), prompts, gen_len=4,
                           extra=extra)
    assert torch.equal(toks, want)


@pytest.mark.parametrize("data", ["host", "device"])
def test_train_cli_equals_train(capsys, data):
    _, hist = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "6", "--workers", "2", "--batch", "2",
                           "--seq", "8", "--data", data])
    assert "final loss" in capsys.readouterr().out
    cfg = TR.get_smoke_config(ARCH)
    run = TRun(schedule="qsr", total_steps=6, peak_lr=3e-3, alpha=0.002,
               h_base=2, warmup_steps=1, remat=False)
    _, want = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8, data=data,
                           device="cpu", log_every=0)
    assert hist == want
    assert all(np.isfinite(loss) for _, _, loss, _ in hist)
