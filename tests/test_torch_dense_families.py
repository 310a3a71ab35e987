"""The port's phi3-medium-14b (an untied head), qwen1.5-110b (QKV bias) and
paligemma-3b (a bidirectional prefix of stub image embeddings) against the
JAX package at their smoke configs: configs, parameter trees, forward, loss
and gradients, prefill, generate, QSR rounds and both CLIs.

Weights come from the JAX package's own init, carried across as numpy
(`from_numpy_tree`); qwen's `bq`, `bk` and `bv`, which that init leaves at
zero, are set to the same nonzero random values in both packages.
paligemma's image prefix is one numpy array handed to both.  Token batches
come from the two packages' TokenStreams, which draw bitwise the same
numbers.  Tolerances as in `test_torch_lm.py` (fp32 sums in another order
on each side):

* configs, parameter trees, the H trace and greedy tokens: equal.
* logits and the loss 1e-5; every gradient leaf 2e-5; prefill's logits
  and cache 1e-5; prefill against the prompt fed through decode 1e-5.
* QSR rounds: per-round loss, grad norm and divergence within 2e-5
  relative (observed 2.4e-6); final params per leaf to a relative L2 of
  2e-4 and every element to 2e-3 (AdamW's m / sqrt(v) is O(1) where a
  gradient sits at the sum-order noise).  qwen's rounds part further: at
  its 5th step one element of the untied `tok` embedding, whose gradient
  sits at that noise, takes AdamW steps of opposite sign in the two
  packages (0.59 lr apart, observed), and the trajectories drift from
  there.  A perturbation of every initial weight by one ulp moves the
  port's own rounds by no more than 4.3e-6, so the drift is that flip's,
  not a chaotic trajectory's.  So qwen is held to the card-vs-CPU
  training gate's 1e-4 on the metrics (observed 6.3e-5), 2e-3 relative
  L2 a leaf (observed 1.2e-3) and 4 lr an element (observed 4.2e-3).
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
from repro.models import transformer as jtf
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
from repro_torch.models import api as tapi
from repro_torch.models import param as tpm
from repro_torch.models import transformer as ttf
from repro_torch.optim import lr as tlr
from torch_one_thread import one_torch_thread  # noqa: F401

LOGIT_TOL = 1e-5
GRAD_TOL = 2e-5
ARCHS = ("phi3-medium-14b", "qwen1.5-110b", "paligemma-3b")
W, B_LOC, SEQ = 2, 2, 16
# the training CLI's run config (launch/train.py main) at 10 steps: five
# rounds of H = 2
RUN = dict(schedule="qsr", optimizer="adamw", total_steps=10, peak_lr=3e-3,
           alpha=0.002, h_base=2, warmup_steps=1, remat=False)
# QSR rounds: (metrics, params' relative L2 a leaf, params' largest
# element); qwen's after its AdamW flip (module docstring)
ROUND_TOL = {"phi3-medium-14b": (2e-5, 2e-4, 2e-3),
             "qwen1.5-110b": (1e-4, 2e-3, 4 * RUN["peak_lr"]),
             "paligemma-3b": (2e-5, 2e-4, 2e-3)}


def _with_random_biases(cfg, jp, seed):
    """qwen's bq, bk, bv set to nonzero random values (the reference inits
    them to zeros, which would test nothing); other configs unchanged."""
    if not cfg.qkv_bias:
        return jp
    rng = np.random.default_rng(seed)
    attn = dict(jp["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            0.1 * rng.standard_normal(attn[name].shape), jnp.float32)
    return {**jp, "layers": {**jp["layers"], "attn": attn}}


def _params(arch, key):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(key))
    jp = _with_random_biases(jcfg, jp, key + 100)
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _params(request.param, 0)


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


def _prefix(cfg, b, seed=0):
    """A VLM's stub image embeddings [b, n_img_tokens, D] (numpy fp32, 0.02
    · normal, the reference's scale), None for any other family."""
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed + 50)
    return (0.02 * rng.standard_normal(
        (b, cfg.n_img_tokens, cfg.d_model))).astype(np.float32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# ------------------------------------------------------- configs, params --

@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_jax_package(arch, get):
    j, t = getattr(JR, get)(arch), getattr(TR, get)(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_count_match(arch):
    """Every ParamDef (the untied head, the QKV biases) equal, full config
    and smoke, and the counts; `from_numpy_tree` carries every leaf."""
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(JR, get)(arch), getattr(TR, get)(arch)
        jdefs = japi.get_module(jc).param_defs(jc)
        tdefs = tapi.get_module(tc).param_defs(tc)
        jl = jax.tree.leaves(jdefs, is_leaf=jpm.is_def)
        tl = T.leaves(tdefs)
        assert [(d.shape, d.axes, d.init, d.scale) for d in jl] == \
            [(d.shape, d.axes, d.init, d.scale) for d in tl]
        assert tpm.count_params(tdefs) == jpm.count_params(jdefs)
    _, tcfg, _, npt = _params(arch, 0)
    tp = tpm.from_numpy_tree(npt, "cpu")
    assert ("head" in tp["embed"]) == (not tcfg.tie_embeddings)
    biases = {"bq", "bk", "bv"} & set(tp["layers"]["attn"])
    assert biases == ({"bq", "bk", "bv"} if tcfg.qkv_bias else set())
    for a, b in zip(jax.tree.leaves(npt), T.leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a)
    for name in biases:
        assert float(tp["layers"]["attn"][name].abs().min()) > 0.0


def test_full_config_counts():
    """The parameter counts the card's phases are sized from."""
    want = {"phi3-medium-14b": 14_659_507_200,
            "qwen1.5-110b": 111_209_914_368, "paligemma-3b": 2_508_662_784}
    for arch, n in want.items():
        cfg = TR.get_config(arch)
        assert tpm.count_params(ttf.param_defs(cfg)) == n
    qwen2 = dataclasses.replace(TR.get_config("qwen1.5-110b"), n_layers=2)
    assert tpm.count_params(ttf.param_defs(qwen2)) == 5_209_387_008


# --------------------------------------------------- forward, loss, grad --

@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(setup, remat):
    jcfg, tcfg, jp, npt = setup
    toks, labels = _tokens(tcfg, 2, SEQ)
    pre = _prefix(tcfg, 2)
    jlogits, _ = jtf.forward(jcfg, jp, jnp.asarray(toks),
                             prefix_embeds=_j(pre), remat=remat)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    if pre is not None:
        jbatch["prefix_embeds"] = jnp.asarray(pre)
        tbatch["prefix_embeds"] = torch.from_numpy(pre)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jbatch, remat=remat))(jp)

    leaves, treedef = T.flatten(tpm.from_numpy_tree(npt, "cpu"))
    alias = [x.requires_grad_(True) for x in leaves]
    tp = T.unflatten(treedef, alias)
    tlogits, taux = ttf.forward(tcfg, tp, torch.from_numpy(toks),
                                prefix_embeds=_t(pre), remat=remat)
    assert tlogits.shape == (2, SEQ, tcfg.vocab)        # text positions
    _close(tlogits.detach(), jlogits, LOGIT_TOL)
    assert float(taux) == 0.0
    tloss = ttf.loss_fn(tcfg, tp, tbatch, remat=remat)
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
    pre = _prefix(tcfg, 3, seed=5)
    p = 0 if pre is None else pre.shape[1]
    max_len = p + 24
    jlog, jcache = jtf.prefill(
        jcfg, jp, jnp.asarray(toks),
        jtf.init_cache(jcfg, 3, max_len, dtype=jnp.float32),
        prefix_embeds=_j(pre))
    cache = ttf.init_cache(tcfg, 3, max_len, device="cpu")
    with torch.no_grad():
        tlog, tcache = ttf.prefill(tcfg, tpm.from_numpy_tree(npt, "cpu"),
                                   torch.from_numpy(toks), cache,
                                   prefix_embeds=_t(pre))
    assert tcache is cache
    _close(tlog, jlog, LOGIT_TOL)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], LOGIT_TOL)
        assert tcache[k][:, :, :p + 11].abs().amax((0, 1, 3, 4)).min() > 0
        assert not tcache[k][:, :, p + 11:].any()


def test_prefill_equals_feeding_the_prompt_through_decode(setup):
    """The port alone: the last position's logits of one full-sequence pass
    and of the prompt fed one token at a time through decode_step (a VLM:
    its prefix and first token prefilled, the rest decoded with
    `prefix_len`)."""
    _, tcfg, _, npt = setup
    toks, _ = _tokens(tcfg, 2, 9, seed=6)
    pre = _prefix(tcfg, 2, seed=6)
    p = 0 if pre is None else pre.shape[1]
    tp = tpm.from_numpy_tree(npt, "cpu")
    with torch.no_grad():
        want, _ = ttf.prefill(tcfg, tp, torch.from_numpy(toks),
                              ttf.init_cache(tcfg, 2, p + 16, device="cpu"),
                              prefix_embeds=_t(pre))
        cache = ttf.init_cache(tcfg, 2, p + 16, device="cpu")
        first = 0
        if pre is not None:
            _, cache = ttf.prefill(tcfg, tp, torch.from_numpy(toks[:, :1]),
                                   cache, prefix_embeds=_t(pre))
            first = 1
        for i in range(first, toks.shape[1]):
            got, cache = ttf.decode_step(tcfg, tp,
                                         torch.from_numpy(toks[:, i]),
                                         cache, p + i, prefix_len=p)
    _close(got, want, LOGIT_TOL)


def test_generate_greedy_tokens_equal_jax(setup):
    jcfg, tcfg, jp, npt = setup
    prompts, _ = _tokens(tcfg, 3, 7, seed=7)
    pre = _prefix(tcfg, 3, seed=7)
    jextra = {} if pre is None else {"prefix_embeds": jnp.asarray(pre)}
    textra = {} if pre is None else {"prefix_embeds": pre}
    want = jserve.generate(jcfg, jp, jnp.asarray(prompts), gen_len=8,
                           extra=jextra)
    ops.reset_launch_counts()
    got = tserve.generate(tcfg, tpm.from_numpy_tree(npt, "cpu"), prompts,
                          gen_len=8, extra=textra)
    assert got.dtype == torch.int32 and got.shape == (3, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(ops.launch_counts().values()) == {0}    # CPU: plain versions


def test_generate_counts_the_prefix_in_the_cache():
    """A VLM's prefix takes the cache's first rows: it counts in the
    default length, and a cache too short for it raises."""
    _, tcfg, _, npt = _params("paligemma-3b", 0)
    tp = tpm.from_numpy_tree(npt, "cpu")
    prompts, _ = _tokens(tcfg, 2, 5, seed=8)
    extra = {"prefix_embeds": _prefix(tcfg, 2, seed=8)}
    a = tserve.generate(tcfg, tp, prompts, gen_len=4, extra=extra)
    b = tserve.generate(tcfg, tp, prompts, gen_len=4, extra=extra,
                        max_len=tcfg.n_img_tokens + 9)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"prefix \(16\)"):
        tserve.generate(tcfg, tp, prompts, gen_len=4, extra=extra,
                        max_len=12)


# ----------------------------------------------------- QSR engine rounds --

def _vlm_batches(cfg, steps, seed=3):
    """Per-step stub prefixes [steps, W, B_LOC, n_img, D] from one numpy
    array, so that both engines see the same bits."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (steps, W, B_LOC, cfg.n_img_tokens, cfg.d_model))).astype(np.float32)


def _jax_rounds(jcfg, jp):
    run = JRun(**RUN)
    kw = {}
    if jcfg.family == "vlm":
        stream, pre = jsyn.TokenStream(vocab=jcfg.vocab), _vlm_batches(
            jcfg, run.total_steps)

        def batch_fn(step):
            b = jsyn.make_train_batch(
                dataclasses.replace(jcfg, family="dense"), stream, step, W,
                B_LOC, SEQ)
            return {**b, "prefix_embeds": jnp.asarray(pre[step])}
        kw["batch_fn"] = batch_fn
    eng = jeng.RoundEngine(jcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", **kw)
    state = eng.init_state(jp)
    lr_fn, t, metrics = jlr.make_lr_fn(run), 0, []
    while t < run.total_steps:
        h = jsched.get_h(run, t, lr_fn)
        state, m = eng.run_round(state, t, h, lr_fn)
        metrics.append({k: float(v) for k, v in m.items()})
        t += h
    return eng.h_trace, metrics, jax.tree.map(np.asarray,
                                               eng.params_single(state))


def _port_rounds(tcfg, npt):
    run = TRun(**RUN)
    kw = {}
    if tcfg.family == "vlm":
        stream, pre = tsyn.TokenStream(vocab=tcfg.vocab), _vlm_batches(
            tcfg, run.total_steps)

        def batch_fn(step):
            toks, labels = zip(*[stream.batch(step, k, B_LOC, SEQ)
                                 for k in range(W)])
            return {"tokens": torch.stack(toks),
                    "labels": torch.stack(labels),
                    "prefix_embeds": torch.from_numpy(pre[step])}
        kw["batch_fn"] = batch_fn
    eng = teng.RoundEngine(tcfg, run, workers=W, b_loc=B_LOC, seq=SEQ,
                           data="host", device="cpu", **kw)
    state = eng.init_state(tpm.from_numpy_tree(npt, "cpu"))
    lr_fn, t = tlr.make_lr_fn(run), 0
    while t < run.total_steps:
        h = tsched.get_h(run, t, lr_fn)
        state, _ = eng.run_round(state, t, h, lr_fn)
        t += h
    return eng, state


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_five_qsr_rounds_match_jax(arch):
    metric_tol, rel_tol, abs_tol = ROUND_TOL[arch]
    jcfg, tcfg, jp, npt = _params(arch, 1)
    j_trace, j_metrics, j_final = _jax_rounds(jcfg, jp)
    eng, state = _port_rounds(tcfg, npt)
    assert eng.h_trace == j_trace and len(j_trace) == 5
    for jm, tm in zip(j_metrics, eng.round_metrics):
        for k in ("loss", "grad_norm", "divergence"):
            assert _rel(jm[k], float(tm[k])) <= metric_tol, (k, jm, tm)
    got = T.leaves(eng.params_single(state))
    for a, b in zip(jax.tree.leaves(j_final), got):
        b = b.numpy()
        assert np.linalg.norm(a - b) <= rel_tol * np.linalg.norm(a)
        assert np.abs(a - b).max() <= abs_tol


# ------------------------------------------------------------ vlm batches --

def test_vlm_train_batches_carry_the_image_prefix():
    """The port's own draw (not the reference's bits): [W, B, P, D] fp32,
    0.02 · normal, a function of the step alone; the tokens are the dense
    batch's, as are an audio batch's beside its frames."""
    cfg = TR.get_smoke_config("paligemma-3b")
    stream = tsyn.TokenStream(vocab=cfg.vocab)
    a = tsyn.make_train_batch(cfg, stream, 3, 2, 4, 8)
    assert set(a) == {"tokens", "labels", "prefix_embeds"}
    pe = a["prefix_embeds"]
    assert pe.dtype == torch.float32
    assert pe.shape == (2, 4, cfg.n_img_tokens, cfg.d_model)
    assert abs(float(pe.std()) - 0.02) < 0.002 and abs(float(pe.mean())) < 0.002
    again = tsyn.make_train_batch(cfg, tsyn.TokenStream(vocab=cfg.vocab), 3,
                                  2, 4, 8)
    assert all(torch.equal(a[k], again[k]) for k in a)
    other = tsyn.make_train_batch(cfg, stream, 4, 2, 4, 8)
    assert not torch.equal(other["prefix_embeds"], pe)
    dense = tsyn.make_train_batch(dataclasses.replace(cfg, family="dense"),
                                  stream, 3, 2, 4, 8)
    assert torch.equal(dense["tokens"], a["tokens"])
    assert torch.equal(dense["labels"], a["labels"])
    audio = tsyn.make_train_batch(
        dataclasses.replace(cfg, family="audio", enc_seq=6), stream, 3, 2, 4,
        8)
    assert set(audio) == {"tokens", "labels", "frames"}
    assert audio["frames"].shape == (2, 4, 6, cfg.d_model)
    assert torch.equal(audio["tokens"], a["tokens"])


# ------------------------------------------------------------------ CLIs --

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_one_shot_generate(arch):
    ops.reset_launch_counts()
    toks = tserve.main(["--smoke", "--device", "cpu", "--arch", arch,
                        "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert toks.shape == (2, 9)
    assert set(ops.launch_counts().values()) == {0}
    cfg = TR.get_smoke_config(arch)
    params = tserve.W.ServingWeights.from_seed(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = np.stack([rng.integers(0, cfg.vocab, 5, dtype=np.int32)
                        for _ in range(2)])
    want = tserve.generate(cfg, params.as_tree(), prompts, gen_len=4,
                           extra=tserve.image_prefix(cfg, 2, "cpu"))
    assert torch.equal(toks, want)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base",
                                  "vit-b16"])
def test_serve_cli_slots_refuses_families_with_extras(arch):
    """The service loop carries no per-request extras (an image prefix,
    audio frames, images): `--slots` refuses the vlm, audio and vision
    families with the reference's message, before it builds weights."""
    family = TR.get_smoke_config(arch).family
    with pytest.raises(SystemExit, match=f"--slots serves decoder families; "
                       f"{family} prompts need per-request extras"):
        tserve.main(["--smoke", "--device", "cpu", "--arch", arch,
                     "--slots", "2", "--batch", "3", "--prompt-len", "4",
                     "--gen", "3"])


CLI = ["--smoke", "--device", "cpu", "--steps", "6", "--workers", "2",
       "--batch", "2", "--seq", "8"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_equals_train(capsys, arch):
    _, hist = ttrain.main(["--arch", arch] + CLI)
    assert "final loss" in capsys.readouterr().out
    cfg = TR.get_smoke_config(arch)
    run = TRun(schedule="qsr", total_steps=6, peak_lr=3e-3, alpha=0.002,
               h_base=2, warmup_steps=1, remat=False)
    _, want = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8, data="host",
                           device="cpu", log_every=0)
    assert hist == want
    assert all(np.isfinite(loss) for _, _, loss, _ in hist)
