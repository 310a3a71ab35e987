"""The port's on-device batches (`data/synthetic.py device_batch_fn`,
`RoundEngine(data="device")`) on the CPU.

`jax.random` has no PyTorch twin, so these batches are not the
reference's bits: the contract is the reference's own, "the same language,
not the same batches".  Held here: shapes and dtypes per family; tokens in
the vocab and labels the tokens shifted by one; every transition one of
the current token's successors in the stream's table or a noise draw, the
noise share near the stream's rate; the extras' scales; determinism in
(seed, step) alone; and engines that train on them.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry as TR
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import engine as teng
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as ttrain
from torch_one_thread import one_torch_thread  # noqa: F401

RUN = dict(schedule="qsr", optimizer="adamw", total_steps=6, peak_lr=3e-3,
           alpha=0.002, h_base=2, warmup_steps=1, remat=False)
FAMILIES = {"starcoder2-3b": set(), "paligemma-3b": {"prefix_embeds"},
            "whisper-base": {"frames"}, "mamba2-130m": set(),
            "zamba2-1.2b": set()}


def _synth(arch, w=2, b=3, seq=8, seed=0):
    cfg = TR.get_smoke_config(arch)
    stream = tsyn.TokenStream(vocab=cfg.vocab, seed=seed)
    return cfg, stream, tsyn.device_batch_fn(cfg, stream, w, b, seq, "cpu")


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_shapes_dtypes_and_shift(arch):
    cfg, _, synth = _synth(arch)
    batch = synth(4)
    assert set(batch) == {"tokens", "labels"} | FAMILIES[arch]
    for k in ("tokens", "labels"):
        assert batch[k].shape == (2, 3, 8) and batch[k].dtype == torch.int32
        assert batch[k].device.type == "cpu"
        assert int(batch[k].min()) >= 0 and int(batch[k].max()) < cfg.vocab
    assert torch.equal(batch["tokens"][..., 1:], batch["labels"][..., :-1])
    if "prefix_embeds" in batch:
        assert batch["prefix_embeds"].shape == (2, 3, cfg.n_img_tokens,
                                                cfg.d_model)
    if "frames" in batch:
        assert batch["frames"].shape == (2, 3, cfg.enc_seq, cfg.d_model)
    for k in FAMILIES[arch]:
        assert batch[k].dtype == torch.float32


def test_transitions_follow_the_table_or_the_noise():
    """Over 4 x 16 x 256 transitions: a transition off the current token's
    successors is a noise draw that missed them, with probability noise x
    (1 - |successors| / vocab); the share of those sits near it, and the
    first tokens and the noise draws cover the vocab."""
    _, stream, synth = _synth("starcoder2-3b", w=4, b=16, seq=256)
    batch = synth(0)
    cur = batch["tokens"].reshape(-1).long().numpy()
    nxt = batch["labels"].reshape(-1).long().numpy()
    succ = stream.succ
    on_table = (succ[cur] == nxt[:, None]).any(-1)
    distinct = np.array([len(set(row)) for row in succ])
    want = float(np.mean(stream.noise * (1 - distinct[cur] / stream.vocab)))
    off = float(np.mean(~on_table))
    assert abs(off - want) < 0.01, (off, want)
    # each successor column is picked about equally often
    picks = [(succ[cur[on_table], c] == nxt[on_table]).mean()
             for c in range(stream.branch)]
    assert min(picks) > 0.2
    assert len(np.unique(batch["tokens"][..., 0].numpy())) > 32


@pytest.mark.parametrize("arch,key,std", [("paligemma-3b", "prefix_embeds",
                                           0.02),
                                          ("whisper-base", "frames", 0.1)])
def test_extras_scales(arch, key, std):
    _, _, synth = _synth(arch, w=2, b=4)
    x = synth(1)[key]
    assert abs(float(x.std()) - std) < 0.05 * std
    assert abs(float(x.mean())) < 0.05 * std


def test_a_batch_is_a_function_of_seed_and_step_alone():
    _, _, synth = _synth("whisper-base")
    first = synth(5)
    synth(3)                                   # whatever ran before
    again = synth(5)
    _, _, fresh = _synth("whisper-base")
    for other in (again, fresh(5)):
        assert all(torch.equal(first[k], other[k]) for k in first)
    later = synth(6)
    assert not torch.equal(first["tokens"], later["tokens"])
    assert not torch.equal(first["frames"], later["frames"])
    _, _, seeded = _synth("whisper-base", seed=1)
    assert not torch.equal(first["tokens"], seeded(5)["tokens"])


@pytest.mark.parametrize("arch", ["starcoder2-3b", "whisper-base"])
def test_engine_trains_on_device_data(arch):
    """train() on `data="device"` (the engine's default): finite losses,
    the batches of the engine's synthesizer, and the tree and flat layouts
    bitwise equal on them."""
    cfg = TR.get_smoke_config(arch)
    run = TRun(**RUN)
    out = {}
    for layout in ("tree", "flat"):
        eng = teng.RoundEngine(cfg, run, workers=2, b_loc=2, seq=8,
                               layout=layout, device="cpu")
        state, hist = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8,
                                   layout=layout, eng=eng, log_every=0)
        assert eng.data == "device" and eng.data_seconds > 0
        assert all(np.isfinite(loss) for _, _, loss, _ in hist)
        out[layout] = (hist, T.leaves(eng.params_single(state)))
    assert out["tree"][0] == out["flat"][0]
    for a, b in zip(out["tree"][1], out["flat"][1]):
        assert torch.equal(a, b)
    want = tsyn.device_batch_fn(cfg, tsyn.TokenStream(vocab=cfg.vocab), 2, 2,
                                8, "cpu")(3)
    got = eng._batch(3)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_resize_redraws_at_the_new_worker_count():
    cfg = TR.get_smoke_config("starcoder2-3b")
    run = TRun(**RUN)
    eng = teng.RoundEngine(cfg, run, workers=2, b_loc=2, seq=8, device="cpu")
    state = eng.init_state()
    state = eng.membership_epoch(state=state, grow_to=3)
    assert eng._batch(0)["tokens"].shape == (3, 2, 8)
    lr_fn = lambda t: 1e-3                              # noqa: E731
    state, m = eng.run_round(state, 0, 2, lr_fn)
    assert np.isfinite(float(m["loss"]))


def test_train_cli_takes_device_data(capsys):
    _, hist = ttrain.main(["--arch", "gemma3-4b", "--smoke", "--device",
                           "cpu", "--steps", "4", "--workers", "2",
                           "--batch", "2", "--seq", "8", "--data", "device"])
    assert "device data" in capsys.readouterr().out
    cfg = TR.get_smoke_config("gemma3-4b")
    run = dataclasses.replace(TRun(**RUN), total_steps=4)
    _, want = ttrain.train(cfg, run, workers=2, b_loc=2, seq=8,
                           device="cpu", log_every=0)
    assert hist == want
