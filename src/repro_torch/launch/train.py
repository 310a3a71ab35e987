"""Training loop: a thin host loop over `repro_torch.core.engine.RoundEngine`
(port of `repro/launch/train.py` `train()`).

It walks the H-schedule: ask `schedules.get_h` for the next round's period,
hand the round to the engine, log.  Both of the paper's algorithms run
through it: Local AdamW with any H-schedule (Alg. 2) and the data-parallel
baseline (Alg. 1 == schedule "parallel", H = 1 every round).

    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.engine import RoundEngine
    from repro_torch.data.synthetic import VisionStream, vision_batch_fn
    from repro_torch.launch.train import train

    cfg = R.get_config("vit-b16")
    run = RunConfig(total_steps=24, warmup_steps=2, peak_lr=6e-3, end_lr=1e-5,
                    h_base=2, alpha=3.5e-3, weight_decay=0.01, remat=False)
    fn = vision_batch_fn(VisionStream(n_classes=1000, image=224), 4, 32)
    eng = RoundEngine(cfg, run, workers=4, b_loc=32, seq=1, data="host",
                      batch_fn=fn)                       # on the card
    state, history = train(cfg, run, workers=4, b_loc=32, seq=1,
                           data="host", eng=eng)

The sync variants run through the same call.  Overlap (the reduce at the
round boundary, applied after the next round's first `overlap_depth`
steps) and partial participation are engine modes; the ring-int8 wire and
the int8 sync are `RunConfig` fields and need the flat layout:

    run = dataclasses.replace(run, sync_quantize=True, sync_wire="ring-int8")
    eng = RoundEngine(cfg, run, workers=4, b_loc=32, seq=1, data="host",
                      batch_fn=fn, layout="flat", sync="overlap",
                      overlap_depth=0)
    state, history = train(cfg, run, workers=4, b_loc=32, seq=1,
                           data="host", layout="flat", sync="overlap",
                           eng=eng)

Under sync="partial", `eng.membership_epoch([1, 1, 0, 1])` before the run
(or between rounds) sets which lanes the boundary mean takes.  Pass
`device="cpu"` to RoundEngine to run any of these on the CPU.

Checkpoints, the async observer and the adaptive controller are not ported
yet (they raise); the CLI `main()` waits for the LM slice, whose default
arch it trains.
"""
from __future__ import annotations

import time

from repro_torch.configs.base import RunConfig
from repro_torch.core import schedules
from repro_torch.core.engine import RoundEngine
from repro_torch.errors import ConfigError
from repro_torch.optim.lr import make_lr_fn


def train(cfg, run_cfg: RunConfig, *, workers: int, b_loc: int, seq: int,
          seed: int = 0, ckpt_dir: str | None = None, log_every: int = 1,
          engine: str = "bucketed", data: str = "device",
          layout: str = "tree", sync: str = "blocking",
          overlap_depth: int = 0, eval_fn=None,
          async_observer: bool = False, eng: RoundEngine | None = None,
          controller_trace: str | None = None, frontier=None, device=None):
    """Run a full training run; returns (state, history).

    history rows are (t_end, h, loss, lr), as the reference's.  Pass an
    `eng` to keep a handle on the engine (H-trace, per-round metrics, data
    time) after the run; otherwise one is built from the mode flags on
    `device`.  `eval_fn(t, state)` runs after every round on the synced
    state (`eng.synced_view`: under overlap, the consensus of the pending
    sync, without consuming it).  The returned state is `eng.flush(state)`:
    fully synced in every sync mode."""
    for bad, what in ((ckpt_dir, "checkpoints"),
                      (async_observer, "the async observer"),
                      (run_cfg.schedule == "adaptive" or controller_trace
                       or frontier, "the adaptive controller")):
        if bad:
            raise ConfigError(f"{what}: not ported yet")
    if eng is None:
        eng = RoundEngine(cfg, run_cfg, workers=workers, b_loc=b_loc,
                          seq=seq, seed=seed, mode=engine, data=data,
                          layout=layout, sync=sync,
                          overlap_depth=overlap_depth, device=device)
    else:
        got = (eng.cfg, eng.run_cfg, eng.workers, eng.b_loc, eng.seq,
               eng.seed, eng.mode, eng.data, eng.layout, eng.sync_mode,
               eng.overlap_depth)
        want = (cfg, run_cfg, workers, b_loc, seq, seed, engine, data,
                layout, sync, overlap_depth)
        if got != want:
            raise ConfigError(
                "engine built with (cfg, run_cfg, workers, b_loc, seq, seed, "
                f"mode, data, layout, sync, overlap_depth)={got},\n"
                f"train() called with {want}")
    state = eng.init_state()
    lr_fn = make_lr_fn(run_cfg)

    history = []
    t_start = time.time()
    t = 0
    while t < run_cfg.total_steps:
        h = schedules.get_h(run_cfg, t, lr_fn)
        state, m = eng.run_round(state, t, h, lr_fn)
        t += h
        loss = float(m["loss"])
        history.append((t, h, loss, lr_fn(t - 1)))
        if log_every and (len(history) % log_every == 0):
            print(f"step {t:6d}  H {h:4d}  lr {lr_fn(t-1):.5f}  "
                  f"loss {loss:.4f}  |g| {float(m['grad_norm']):.3f}  "
                  f"div {float(m['divergence']):.4f}  "
                  f"({time.time()-t_start:.1f}s)")
        if eval_fn is not None:
            eval_fn(t, eng.synced_view(state))
    return eng.flush(state), history
