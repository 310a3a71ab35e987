"""The port's continuous-batching server against the JAX package's, at the
gemma3 smoke config on the CPU.

Greedy tokens must equal the JAX `ContinuousBatcher`'s exactly: both
packages run the same weights (carried across as numpy) and the logits
agree to ~1e-6, far inside the top-2 margins of these random models.
Sampling at temperature > 0 uses torch generators whose stream differs from
JAX's `fold_in` keys, so there the port is held to its own invariants: a
request's samples do not depend on co-scheduling, and a hot swap's replay
rejoins the same stream.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.launch import batching as jbatching
from repro.launch import serve as jserve
from repro.launch import weights as jweights
from repro.models import api as japi
from repro.models import param as jpm
from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import weights as W
from repro_torch.launch.batching import ContinuousBatcher, Request
from repro_torch.models import api as tapi
from repro_torch.models import param as tpm
from torch_one_thread import one_torch_thread  # noqa: F401

ARCH = "gemma3-4b"


def _jax_params(seed):
    cfg = JR.get_smoke_config(ARCH)
    return jpm.init_params(japi.get_module(cfg).param_defs(cfg),
                           jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def weights():
    """Two weight sets as (jax tree, numpy tree)."""
    out = {}
    for seed in (0, 7):
        jp = _jax_params(seed)
        out[seed] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _cfg():
    return TR.get_smoke_config(ARCH)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _port(npt):
    return tpm.from_numpy_tree(npt, "cpu")


def _serve_port(npt, prompts, *, slots, max_len, max_new, **kw):
    b = ContinuousBatcher(_cfg(), _port(npt), slots=slots, max_len=max_len,
                          device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    b.run()
    return b, reqs


def _serve_jax(jp, prompts, *, slots, max_len, max_new):
    b = jbatching.ContinuousBatcher(JR.get_smoke_config(ARCH), jp,
                                    slots=slots, max_len=max_len)
    reqs = [jbatching.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    b.run()
    return b, reqs


def test_greedy_tokens_equal_jax_batcher(weights):
    """3 requests over 2 slots (a slot is recycled), max_len 48."""
    jp, npt = weights[0]
    prompts = [_prompt(i, n) for i, n in enumerate((5, 9, 7))]
    _, got = _serve_port(npt, prompts, slots=2, max_len=48, max_new=8)
    _, want = _serve_jax(jp, prompts, slots=2, max_len=48, max_new=8)
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    assert [r.epochs for r in got] == [[0] * 8] * 3


def test_batched_equals_each_request_alone(weights):
    _, npt = weights[0]
    prompts = [_prompt(10 + i, n) for i, n in enumerate((4, 11, 6))]
    _, packed = _serve_port(npt, prompts, slots=2, max_len=32, max_new=5)
    for p, r in zip(prompts, packed):
        _, (solo,) = _serve_port(npt, [p], slots=1, max_len=32, max_new=5)
        assert solo.out == r.out


def test_retire_at_max_len_then_step(weights):
    """Request 0 retires at pos == max_len (16 cache rows, 6-token prompt:
    11 tokens); its dead lane still goes to the decode step at position
    max_len while request 2, admitted later, runs on.  The clamped write
    keeps that legal, and every token equals the JAX batcher's."""
    jp, npt = weights[0]
    prompts = [_prompt(20, 6), _prompt(21, 2), _prompt(22, 3)]
    max_len = 16
    b = ContinuousBatcher(_cfg(), _port(npt), slots=2, max_len=max_len,
                          device="cpu")
    reqs = [Request(rid=0, prompt=prompts[0], max_new=100),
            Request(rid=1, prompt=prompts[1], max_new=2),
            Request(rid=2, prompt=prompts[2], max_new=100)]
    for r in reqs:
        b.submit(r)
    dead_lane_steps = 0
    while True:
        if reqs[0].done and b.active[0] is None and b.pos[0] == max_len \
                and any(r is not None for r in b.active):
            dead_lane_steps += 1
        if b.step() == 0 and not b.queue:
            break
    assert dead_lane_steps > 0
    assert all(r.done for r in reqs)
    assert len(reqs[0].out) == max_len - 6 + 1
    jb = jbatching.ContinuousBatcher(JR.get_smoke_config(ARCH), jp, slots=2,
                                     max_len=max_len)
    jreqs = [jbatching.Request(rid=r.rid, prompt=r.prompt,
                               max_new=r.max_new) for r in reqs]
    for r in jreqs:
        jb.submit(r)
    jb.run()
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_slot_recycle_zeroes_the_lane(weights):
    """An admitted request finds its lane zeroed, and its tokens equal those
    of a fresh server."""
    _, npt = weights[0]
    pa, pb = _prompt(30, 6), _prompt(31, 5)
    b = ContinuousBatcher(_cfg(), _port(npt), slots=1, max_len=32,
                          device="cpu")
    r1, r2 = Request(rid=0, prompt=pa, max_new=4), \
        Request(rid=1, prompt=pb, max_new=4)
    b.submit(r1)
    b.submit(r2)
    while not r1.done:
        b.step()
    assert torch.any(b.cache["k"][:, 0] != 0)
    b._admit()                              # admits r2 into the used lane
    assert b.active[0] is r2
    assert torch.all(b.cache["k"][:, 0] == 0)
    assert torch.all(b.cache["v"][:, 0] == 0)
    b.run()
    _, (fresh,) = _serve_port(npt, [pb], slots=1, max_len=32, max_new=4)
    assert r2.out == fresh.out


def test_submit_rejects_overlong_prompt(weights):
    _, npt = weights[0]
    b = ContinuousBatcher(_cfg(), _port(npt), slots=1, max_len=8,
                          device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        b.submit(Request(rid=0, prompt=_prompt(1, 9), max_new=2))


# ---------------------------------------------------------------- hot swap --

def test_serving_weights_swap_in_place_and_audit(weights):
    _, npt0 = weights[0]
    _, npt1 = weights[7]
    sw = W.ServingWeights(_cfg(), _port(npt0), step=3, device="cpu")
    tree = sw.as_tree()
    ep = sw.swap(_port(npt1), step=11, source="publish", tokens_before=5)
    assert (sw.epoch, sw.step) == (1, 11)
    assert (ep.index, ep.step, ep.tokens_before) == (1, 11, 5)
    assert sw.as_tree() is tree             # same views, new contents
    for a, b in zip(T.leaves(tree), T.leaves(npt1)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert [r["index"] for r in sw.audit()] == [0, 1]
    assert [r["step"] for r in sw.audit()] == [3, 11]


def test_weight_subscriber_latest_wins(weights):
    sub = W.WeightSubscriber()
    sub.publish(1, _port(weights[0][1]))
    sub.publish(3, _port(weights[7][1]))
    sub.publish(2, _port(weights[0][1]))      # older than queued: dropped
    step, source, _ = sub.take()
    assert (step, source) == (3, "publish")
    assert sub.superseded == 1
    assert sub.take() is None


def test_hot_swap_matches_restart_and_jax(weights):
    """Publish new weights mid-sequence: post-swap tokens equal a server
    restarted on those weights given the known stream, the epoch stamps
    split the stream at the swap, and the whole stream equals the JAX
    batcher's under the same swap."""
    (jp0, npt0), (jp1, npt1) = weights[0], weights[7]
    prompt = _prompt(40, 5)
    sub = W.WeightSubscriber()
    b = ContinuousBatcher(_cfg(), _port(npt0), slots=2, max_len=48,
                          subscriber=sub, device="cpu")
    req = Request(rid=0, prompt=prompt, max_new=8)
    b.submit(req)
    while len(req.out) < 3:
        b.step()
    sub.publish(1, _port(npt1))
    b.run()
    assert req.done and len(req.out) == 8 and b.swaps == 1
    assert req.epochs == [0] * 3 + [1] * 5
    row = b.weights.epochs[-1]
    assert (row.index, row.step, row.tokens_before) == (1, 1, 3)

    prompt2 = np.concatenate([prompt, np.asarray(req.out[:3], np.int32)])
    _, (rref,) = _serve_port(npt1, [prompt2], slots=2, max_len=48, max_new=5)
    assert rref.out == req.out[3:]

    jsub = jweights.WeightSubscriber()
    jb = jbatching.ContinuousBatcher(JR.get_smoke_config(ARCH), jp0, slots=2,
                                     max_len=48, subscriber=jsub)
    jreq = jbatching.Request(rid=0, prompt=prompt, max_new=8)
    jb.submit(jreq)
    while len(jreq.out) < 3:
        jb.step()
    jsub.publish(1, jp1)
    jb.run()
    assert jreq.out == req.out and jreq.epochs == req.epochs


def test_run_service_audit_and_swap_hook(weights):
    sub = W.WeightSubscriber()
    prompts = [_prompt(50 + i, n) for i, n in enumerate((4, 6, 5))]
    w1 = _port(weights[7][1])
    hooks = [(6, lambda b: sub.publish(1, w1))]
    reqs, audit = tserve.run_service(
        _cfg(), W.ServingWeights(_cfg(), _port(weights[0][1]), device="cpu"),
        prompts, slots=2, max_new=4, subscriber=sub, hooks=hooks)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert audit["swaps"] == 1 and audit["tokens_emitted"] == 12
    assert audit["device"] == "cpu"
    assert [row["index"] for row in audit["swap_epochs"]] == [0, 1]
    assert {e for r in audit["requests"] for e in r["epochs"]} == {0, 1}


# ---------------------------------------------------------------- sampling --

def test_sampling_is_per_request_deterministic(weights):
    """Token t of request r is a pure function of (seed, rid, t): the same
    requests under 1 and 3 slots give the same streams."""
    _, npt = weights[0]
    prompts = [_prompt(60 + i, n) for i, n in enumerate((5, 7, 6))]

    def serve(slots, seed=11):
        _, reqs = _serve_port(npt, prompts, slots=slots, max_len=32,
                              max_new=5, temperature=1.0, seed=seed)
        return [r.out for r in reqs]

    solo = serve(1)
    assert solo == serve(3)
    assert any(len(set(o)) > 1 for o in solo)        # actually sampling
    assert solo != serve(1, seed=12)


def test_sampling_survives_hot_swap_replay(weights):
    """Post-swap replay rejoins the same per-request sample stream: the
    restart reference matches at temperature > 0."""
    _, npt0 = weights[0]
    _, npt1 = weights[7]
    prompt = _prompt(70, 5)
    sub = W.WeightSubscriber()
    b = ContinuousBatcher(_cfg(), _port(npt0), slots=1, max_len=48,
                          temperature=1.0, seed=5, subscriber=sub,
                          device="cpu")
    req = Request(rid=0, prompt=prompt, max_new=7)
    b.submit(req)
    while len(req.out) < 3:
        b.step()
    sub.publish(1, _port(npt1))
    b.run()
    assert req.done and b.swaps == 1
    ref = ContinuousBatcher(_cfg(), _port(npt1), slots=1, max_len=48,
                            temperature=1.0, seed=5, device="cpu")
    rref = Request(rid=0, prompt=prompt, max_new=7, out=list(req.out[:3]))
    ref.submit(rref)
    ref.run()
    assert rref.out[3:] == req.out[3:]


# ------------------------------------------------------- entry points -----

def test_entry_points_refuse_to_run_on_cpu_unasked(weights, monkeypatch):
    """No card and no explicit CPU request is an error, never a silent CPU
    run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        ContinuousBatcher(_cfg(), _port(weights[0][1]), slots=1, max_len=8)
    with pytest.raises(ConfigError, match="no CUDA device"):
        W.ServingWeights.from_seed(_cfg(), 0)
    with pytest.raises(ConfigError, match="no CUDA device"):
        tserve.main(["--smoke", "--slots", "1", "--batch", "1"])


def test_serve_cli_on_cpu_with_swap_demo(tmp_path):
    path = tmp_path / "audit.json"
    ops.reset_launch_counts()
    audit = tserve.main(["--smoke", "--device", "cpu", "--slots", "2",
                         "--batch", "3", "--prompt-len", "6", "--gen", "6",
                         "--swap-demo", "--audit", str(path)])
    assert audit["swaps"] == 1 and audit["tokens_emitted"] == 18
    assert json.loads(path.read_text())["decode_steps"] == \
        audit["decode_steps"]
    assert set(ops.launch_counts().values()) == {0}    # CPU: plain versions
    # ragged positions do not run on a ring cache (in both packages'
    # attn_apply): the service loop refuses --window, where the
    # reference's ignores it
    with pytest.raises(ConfigError, match="--window with --slots"):
        tserve.main(["--smoke", "--device", "cpu", "--slots", "2",
                     "--window", "8"])


# ------------------------------------------------- ring-buffer serving --

RING_ARCHS = ("gemma3-4b", "starcoder2-3b", "whisper-base")


def _ring_setup(arch):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jp = jpm.init_params(japi.get_module(jcfg).param_defs(jcfg),
                         jax.random.PRNGKey(0))
    extra = {}
    if tcfg.family == "audio":
        extra["frames"] = (0.1 * np.random.default_rng(3).standard_normal(
            (2, tcfg.enc_seq, tcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jp, _port(jax.tree.map(np.asarray, jp)), extra


@pytest.mark.parametrize("window", [16, 8])
@pytest.mark.parametrize("arch", RING_ARCHS)
def test_ring_generate_equals_jax(arch, window):
    """One-shot generate with `window_override`: 6 prompt + 70 new tokens
    run past every smoke config's ring cache (gemma3's 32 rows, its local
    window; starcoder2's 64; whisper's `window` rows), and the greedy
    tokens equal the JAX package's."""
    jcfg, tcfg, jp, tp, extra = _ring_setup(arch)
    prompts = np.stack([_prompt(s, 6) for s in (1, 2)])
    want = jserve.generate(jcfg, jp, jnp.asarray(prompts), gen_len=70,
                           window_override=window,
                           extra={k: jnp.asarray(v) for k, v in
                                  extra.items()})
    cache = tapi.get_module(tcfg).init_cache(
        tcfg, 2, 76, device="cpu", window_override=window)
    assert cache["k"].shape[2] < 76                  # a ring, not the stream
    got = tserve.generate(tcfg, tp, prompts, gen_len=70,
                          window_override=window, extra=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_tokens_differ_from_the_full_cache():
    """gemma3-smoke at window 16: past its 32-row ring the global layer
    sees only the last 32 positions, so the tokens part from the full
    cache's."""
    _, tcfg, _, tp, _ = _ring_setup("gemma3-4b")
    prompts = np.stack([_prompt(s, 6) for s in (1, 2)])
    ring = tserve.generate(tcfg, tp, prompts, gen_len=70, window_override=16)
    full = tserve.generate(tcfg, tp, prompts, gen_len=70)
    assert torch.equal(ring[:, :38], full[:, :38])   # before the wrap
    assert not torch.equal(ring, full)


@pytest.mark.parametrize("arch", RING_ARCHS)
def test_ring_refuses_a_prompt_longer_than_the_ring(arch):
    """The prefill writes the prompt whole from row 0: a prompt longer than
    the ring cache raises, naming both lengths, and never writes out of
    range."""
    _, tcfg, _, tp, extra = _ring_setup(arch)
    prompts = np.stack([_prompt(s, 70) for s in (1, 2)])
    with pytest.raises(ValueError, match=r"prompt \(70\) \+ prefix \(0\) = "
                       r"70 tokens exceed the ring KV cache length \d+"):
        tserve.generate(tcfg, tp, prompts, gen_len=4, window_override=8,
                        extra=extra)
