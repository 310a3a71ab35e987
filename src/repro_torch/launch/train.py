"""Training loop: a thin host loop over `repro_torch.core.engine.RoundEngine`
(port of `repro/launch/train.py`: `train()` and the CLI `main()`).

It walks the H-schedule: ask `schedules.get_h` for the next round's period,
hand the round to the engine, log.  Both of the paper's algorithms run
through it: Local AdamW with any H-schedule (Alg. 2) and the data-parallel
baseline (Alg. 1 == schedule "parallel", H = 1 every round).

The CLI trains an LM on the built-in token stream, on the card unless
`--device cpu` is passed:

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --smoke --device cpu --steps 30 --workers 2 --batch 2 --seq 16

Its flags and defaults are the reference's, with one difference: `--data`
defaults to `host` (the numpy `TokenStream`, bitwise the reference's host
batches); `--data device` draws the same language on the card
(`data/synthetic.py device_batch_fn`), as the reference's device path
does, but not its bits (`jax.random` has no twin).  `--ckpt DIR`
checkpoints the run into DIR (every `steps // 4` steps and at the end) and
resumes from it when it holds one, in either layout; `--async-observer`
writes the mid-run checkpoints from a background thread
(`core/observer.py`).  `--schedule adaptive` runs the closed-loop
controller (`core/controller.py`) around every round; `--controller-trace
PATH` writes its decisions (schema controller_trace/v1) and `--frontier
PATH` (a table4_walltime JSON, or a `{depth: s_per_round}` one) lets it
choose the overlap depth under `--sync overlap`:

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --smoke --device cpu --steps 24 --workers 2 --batch 4 --seq 16 \
        --schedule adaptive --controller-trace trace.json

`--param-layout flat_sharded` pads the flat buckets to a multiple of the
worker count (bitwise the flat layout).  `--mesh 2x1 --param-layout
flat_sharded` (with `--policy`) runs one rank per process over
`torch.distributed`: start the mesh's product of processes with
`multihost --spawn` (or the REPRO_* environment), each a rank of the mesh
engine (`core/engine.py`); `--backend gloo` (default; CPU tensors, or
every rank on one card) or `nccl` (one card per rank):

    PYTHONPATH=src python -m repro_torch.launch.multihost --spawn 2 \
        --mode train -- --arch starcoder2-3b --smoke --device cpu \
        --mesh 2x1 --param-layout flat_sharded --workers 2 --steps 4 \
        --batch 2 --seq 16

Started alone, `--mesh` raises a `ConfigError` that says how to spawn (the
reference runs a mesh of simulated devices in one process; the port runs
one process a rank).

From Python, any model the port trains (here ViT-B/16 on its image stream):

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

Train to serve: with `async_observer=True` an `eval_fn` runs on the
observer's thread with the staged host state, so it can publish the
consensus weights to a directory a server watches (`launch/weights.py`):

    def publish(t, state):            # the worker-0 params of the snapshot
        publish_weights(watch, T.map(lambda x: x[0], state["params"]),
                        step=t)
    train(cfg, run, ..., ckpt_dir=ckpt, async_observer=True, eval_fn=publish)

The adaptive controller (`schedule="adaptive"` in the RunConfig) drives H,
the effective batch (`eng.batch_epoch`, on an engine built with
`adaptive_batch=True`) and, with `sync="overlap"` and a `frontier`, the
overlap depth; `controller_trace="trace.json"` keeps its decisions.
`RunConfig(microbatch=mb)` accumulates each step's gradient over mb chunks
of the per-worker batch.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import registry as R
from repro_torch.configs.base import RunConfig
from repro_torch.core import schedules
from repro_torch.core.controller import AdaptiveController, load_frontier
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
    fully synced in every sync mode.

    `ckpt_dir`: the run resumes from the checkpoint there, if any (at its
    round boundary, in either layout), writes one every
    `total_steps // 4` steps (at the round boundaries that land on a
    multiple) and the final state at the end.  Inline, a mid-run
    checkpoint is a forced sync point under overlap (`flush`).

    `async_observer=True` moves eval and the mid-run checkpoints off the
    round loop: the synced view is submitted to an `AsyncObserver`, which
    clones it on the device and hands it to its thread, where `eval_fn`
    (with the host state) and the checkpoint writer run in that order
    (`fanout`); a superseded snapshot's checkpoint request rides the newer
    one.  The final checkpoint is written after the run's flush.

    schedule="adaptive" swaps the open-loop `schedules.get_h` walk for an
    `AdaptiveController` (core/controller.py) around every round: H gets a
    divergence correction on top of the QSR prior, the effective
    per-worker batch grows through `batch_epoch`s (engines built with
    `adaptive_batch=True`, as an engine built here is under the bucketed
    mode), and with sync="overlap" and a `frontier` ({depth: s/round} or
    the path of a table4_walltime JSON) the overlap depth rides the
    walltime frontier.  `controller_trace` names the JSON file the
    decisions are written to after the run (schema controller_trace/v1).
    The controller reads each round's metrics to the host (one device
    sync a round) and keeps no state in a checkpoint: a resumed run
    recalibrates, as the reference's does."""
    adaptive = run_cfg.schedule == "adaptive"
    if eng is None:
        eng = RoundEngine(cfg, run_cfg, workers=workers, b_loc=b_loc,
                          seq=seq, seed=seed, mode=engine, data=data,
                          layout=layout, sync=sync,
                          overlap_depth=overlap_depth,
                          adaptive_batch=adaptive and engine == "bucketed",
                          device=device)
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

    ctrl = None
    if adaptive:
        if isinstance(frontier, str):
            frontier = load_frontier(frontier)
        ctrl = AdaptiveController(run_cfg, lr_fn, engine=eng,
                                  frontier=frontier)

    step0 = 0
    if ckpt_dir and ckpt_io.exists(ckpt_dir):
        state, step0 = eng.restore(ckpt_dir, state)
        print(f"restored checkpoint at round boundary {step0} "
              f"({len(eng.h_trace)} rounds done)")

    observer = None
    if async_observer and (eval_fn is not None or ckpt_dir):
        from repro_torch.core.observer import AsyncObserver, fanout

        def evaluate(step, snap):
            if eval_fn is not None:
                eval_fn(step, snap["state"])

        def write(step, snap):
            if snap.get("save"):
                ckpt_io.save(ckpt_dir, snap["state"], step=step,
                             extra=snap["extra"])
        # a superseded snapshot's checkpoint request rides the newer one
        # (the newer consensus is a strictly better checkpoint)
        observer = AsyncObserver(
            fanout(evaluate, write),
            merge=lambda old, new: ({**new, "save": True}
                                    if old.get("save") else new))

    history = []
    t_start = time.time()
    t = saved_at = step0
    try:
        while t < run_cfg.total_steps:
            h = (ctrl.begin_round(t) if ctrl is not None
                 else schedules.get_h(run_cfg, t, lr_fn))
            state, m = eng.run_round(state, t, h, lr_fn)
            if ctrl is not None:
                ctrl.end_round(t, h, m)
            t += h
            loss = float(m["loss"])
            history.append((t, h, loss, lr_fn(t - 1)))
            if log_every and (len(history) % log_every == 0):
                print(f"step {t:6d}  H {h:4d}  lr {lr_fn(t-1):.5f}  "
                      f"loss {loss:.4f}  |g| {float(m['grad_norm']):.3f}  "
                      f"div {float(m['divergence']):.4f}  "
                      f"({time.time()-t_start:.1f}s)")
            want_ckpt = bool(ckpt_dir) and \
                t % max(run_cfg.total_steps // 4, 1) == 0
            if observer is not None:
                if eval_fn is not None or want_ckpt:
                    # the synced consensus (pure view: the pending sync is
                    # untouched), cloned on the device by submit
                    observer.submit(t, {"state": eng.synced_view(state),
                                        "save": want_ckpt,
                                        "extra": eng.checkpoint_extra()})
                    if want_ckpt:
                        saved_at = t
            else:
                if eval_fn is not None:
                    eval_fn(t, eng.synced_view(state))
                if want_ckpt:
                    # under overlap a checkpoint is a forced sync point
                    state = eng.flush(state)
                    eng.save(ckpt_dir, state, step=t)
                    saved_at = t
        state = eng.flush(state)
    finally:
        if observer is not None:
            observer.close()
    if ckpt_dir and saved_at != t:
        eng.save(ckpt_dir, state, step=t)
    if ctrl is not None and controller_trace:
        ctrl.write_trace(controller_trace)
        print(f"controller trace ({len(ctrl.trace)} rounds) -> "
              f"{controller_trace}")
    return state, history


def _mesh(args):
    """The rank's Mesh for `--mesh`: the default process group must already
    hold the mesh's product of processes (multihost --spawn, or the REPRO_*
    environment, which this wires up)."""
    import torch.distributed as dist

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import Mesh
    if args.param_layout != "flat_sharded":
        raise ConfigError("--mesh needs --param-layout flat_sharded")
    dims, axes = multihost._parse_mesh(args.mesh)
    if not dist.is_initialized():
        multihost.initialize(backend=args.backend)
    n = 1
    for d in dims:
        n *= d
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ConfigError(
            f"--mesh {args.mesh} runs one process per rank: start {n} with "
            f"`python -m repro_torch.launch.multihost --spawn {n} --mode "
            f"train -- <these flags>` (or the REPRO_* environment)")
    device = multihost.rank_device(args.device or "cuda", args.backend)
    return Mesh(dims, axes, backend=args.backend, device=device)


def main(argv=None):
    """The reference's training CLI.  Returns (state, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--schedule", default="qsr",
                    choices=list(schedules.SCHEDULE_KINDS))
    ap.add_argument("--engine", default="bucketed",
                    choices=["bucketed", "legacy"],
                    help="kept for the reference's CLI: the port runs "
                         "eagerly, with nothing to compile or cache")
    ap.add_argument("--data", default="host", choices=["device", "host"],
                    help="host: the numpy TokenStream, copied to the device "
                         "each step; device: the same Markov language "
                         "drawn on the device from a seeded generator")
    ap.add_argument("--param-layout", default="tree",
                    choices=["tree", "flat", "flat_sharded"],
                    help="tree: state mirrors the model tree; flat: one "
                         "[W, N] buffer per dtype bucket, one optimizer and "
                         "one sync launch per bucket, bitwise the tree run")
    ap.add_argument("--sync", default="blocking",
                    choices=["blocking", "overlap", "partial"])
    ap.add_argument("--overlap-depth", type=int, default=0,
                    help="local steps the next round runs on stale params "
                         "before the deferred sync applies (--sync overlap)")
    ap.add_argument("--mesh", default=None,
                    help="run the rounds on a mesh of ranks, e.g. 2x2 (data "
                         "x model) or 2x1x2 (pod x data x model), one "
                         "process each (multihost --spawn): needs "
                         "--param-layout flat_sharded; --workers must equal "
                         "the policy's worker count on the mesh")
    ap.add_argument("--policy", default="dp", choices=["dp", "fsdp"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="--mesh: the process group's backend")
    ap.add_argument("--async-observer", action="store_true",
                    help="mid-run checkpoints (and eval) on a background "
                         "thread fed by the engine's synced_view")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--quantize", action="store_true",
                    help="int8-quantized sync deltas; implied by --wire "
                         "ring-int8")
    ap.add_argument("--wire", default="auto", choices=["auto", "ring-int8"])
    ap.add_argument("--controller-trace", default=None,
                    help="--schedule adaptive: JSON path for the per-round "
                         "controller decisions (schema controller_trace/v1)")
    ap.add_argument("--frontier", default=None,
                    help="--schedule adaptive + --sync overlap: a "
                         "table4_walltime JSON whose s/round rows give the "
                         "overlap-depth walltime frontier")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--alpha", type=float, default=0.002)
    ap.add_argument("--h-base", type=int, default=2)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: resumed from when it holds "
                         "a checkpoint (either layout)")
    args = ap.parse_args(argv)
    mesh = _mesh(args) if args.mesh else None

    cfg = R.get_smoke_config(args.arch) if args.smoke else R.get_config(args.arch)
    run_cfg = RunConfig(
        schedule=args.schedule, optimizer=args.optimizer, sharding=args.policy,
        total_steps=args.steps, peak_lr=args.peak_lr, alpha=args.alpha,
        h_base=args.h_base, warmup_steps=max(args.steps // 20, 1),
        remat=False,
        sync_quantize=args.quantize or args.wire == "ring-int8",
        sync_wire=args.wire)
    eng = RoundEngine(cfg, run_cfg, workers=args.workers, b_loc=args.batch,
                      seq=args.seq, mode=args.engine, data=args.data,
                      layout=args.param_layout, sync=args.sync,
                      overlap_depth=args.overlap_depth,
                      adaptive_batch=(args.schedule == "adaptive"
                                      and args.engine == "bucketed"),
                      mesh=mesh, policy=args.policy,
                      device=None if mesh is not None else args.device)
    state, hist = train(cfg, run_cfg, workers=args.workers, b_loc=args.batch,
                        seq=args.seq, ckpt_dir=args.ckpt, engine=args.engine,
                        data=args.data, layout=args.param_layout,
                        sync=args.sync, overlap_depth=args.overlap_depth,
                        async_observer=args.async_observer, eng=eng,
                        controller_trace=args.controller_trace,
                        frontier=args.frontier)
    losses = [loss for _, _, loss, _ in hist]
    if not losses:
        print("nothing to do: checkpoint already at "
              f"step {run_cfg.total_steps}")
        return state, hist
    n_sync = len(hist)
    # the reference ends with its XLA compile-cache stats; PyTorch compiles
    # nothing, so the line names the device instead
    print(f"\nfinal loss {losses[-1]:.4f}  (first {losses[0]:.4f}); "
          f"{n_sync} communication rounds for {args.steps} steps "
          f"(comm volume {n_sync/args.steps:.1%} of data-parallel); "
          f"XLA round programs: not applicable (eager PyTorch on "
          f"{eng.device}; {eng.data} data {eng.data_seconds:.2f}s)")
    return state, hist


if __name__ == "__main__":
    main()
