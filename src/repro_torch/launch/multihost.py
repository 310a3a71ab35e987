"""One rank per process over `torch.distributed`, and the harness that runs
the sharded sync and RoundEngine rounds across real process boundaries
(port of `repro/launch/multihost.py`).

`initialize()` wires the default process group from the REPRO_*
environment (the reference's variables):

  REPRO_COORDINATOR    host:port of rank 0 (or a file:// store)
  REPRO_NUM_PROCESSES  the world size
  REPRO_PROCESS_ID     this process's rank

Every rank then builds the same `launch/mesh.py` Mesh; rank r holds worker
i's chunk s of the flat state (`core/flat.py flat_state_slices`), and the
sync's reduce-scatter / all-gather halves (`core/sync.py`) cross process
boundaries.  `run_sync` asserts each rank's chunks against the mesh-less
host path it also runs (bitwise when quantized: the worker mean runs over
integer codes; within `ring_tolerance` for the ring wire); `run_engine`
runs full rounds of the mesh engine against the single-process mesh-less
engine; `probe` runs every collective verb once and checks its values.

Spawn the ranks on one machine (the CPU, gloo):

    PYTHONPATH=src python -m repro_torch.launch.multihost --spawn 4 \\
        --mode sync --mesh 2x2 --quantize --device cpu

On one card every rank runs on it over gloo (`--device cuda --backend
gloo`: payloads staged through host memory); with one card per rank,
`--backend nccl`.  Each rank prints one JSON line with the reference's
keys (`ok`, `max_abs_diff`, `digest`, `shard_hashes`, `wire_dtype`, ...);
`shard_hashes` are keyed by the same global slices as the reference's, so
their union over the ranks compares with a JAX run's.  The reference's
output sharding after a sync holds every worker's lane of a shard chunk
on each device (all lanes hold the consensus), so a params key names a
[W, n] block: a rank gathers its worker group's rows for it.

Elastic rounds (`--mode elastic`) and fault injection (`--chaos`): a gloo
group cannot resize in place (a dead member stalls every collective), so
each worker set is one generation of processes, and the manifest
checkpoint (`checkpoint/io.py save_sharded`) is what crosses between
generations.  Within a generation of L lanes, L ranks of an L x 1 dp mesh
run `--sync partial` engine rounds in lockstep, write a manifest at every
round boundary and exchange heartbeat files before each round's
collectives; a rank that died cannot announce, so the survivors detect the
loss within a bounded timeout, exit 3 with a membership verdict, and the
controller (`--spawn N --chaos ...`) respawns the surviving lanes from the
last manifest, each generation held against one process running the same
lanes on the mesh-less engine:

    PYTHONPATH=src python -m repro_torch.launch.multihost --spawn 4 \\
        --chaos preempt-restore --quantize --device cpu \\
        --heartbeat-timeout 10

  --chaos kill:worker=2,round=1   rank 2 dies at round 1; 3 ranks finish
                                  the run, the consensus bitwise a 3-lane
                                  one-process run
  --chaos preempt-restore         ...then 4 ranks rejoin the lost lane
                                  from the manifest, within 1e-5 / 1e-4 of
                                  a 4-lane one-process run
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.errors import ConfigError

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
WORKER_MODULE = "repro_torch.launch.multihost"


def initialize(*, backend: str = "gloo", timeout_s: float = 300.0) -> bool:
    """Initialize the default process group from the REPRO_* environment;
    returns False (nothing done) when REPRO_COORDINATOR is unset.
    REPRO_COORDINATOR is host:port (a TCP store at rank 0) or a file://
    URL (a file store: what the tests use, no port to race for).  Every
    collective of the group times out after `timeout_s`."""
    coord = os.environ.get("REPRO_COORDINATOR")
    if not coord:
        return False
    method = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(
        backend, init_method=method,
        world_size=int(os.environ["REPRO_NUM_PROCESSES"]),
        rank=int(os.environ["REPRO_PROCESS_ID"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device: str, backend: str) -> torch.device:
    """The rank's device: the CPU, or a card — rank r's own card
    (r mod count) under nccl, which refuses two ranks on one card; card 0
    under gloo when there is one card."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise ConfigError("no CUDA device is available; pass --device cpu")
    n = torch.cuda.device_count()
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if backend == "nccl" and world > n:
        raise ConfigError(f"nccl needs one card per rank: {world} ranks, "
                          f"{n} cards (use --backend gloo)")
    idx = rank % n
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def runtime_info() -> dict:
    on = dist.is_initialized()
    return {"process_index": dist.get_rank() if on else 0,
            "process_count": dist.get_world_size() if on else 1,
            "backend": dist.get_backend() if on else None}


def _parse_mesh(mesh: str):
    dims = tuple(int(x) for x in mesh.split("x"))
    axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return dims, axes


def _demo_params(seed: int = 0) -> dict:
    """The reference's mixed-dtype params for the sync harness (numpy
    draws, bit for bit: two dtype buckets, sizes chosen so the W * S
    chunking pads), as torch tensors on the CPU."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    return {
        "w_in": mk(13, 24), "w_attn": mk(24, 24), "bias": mk(17),
        "w_out": mk(24, 13), "gate": mk(3, 5, 7),
        "h_bf16": mk(9, 11).to(torch.bfloat16),
        "e_bf16": mk(21).to(torch.bfloat16),
    }


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(_bytes(a))
    return h.hexdigest()


def _key(tag: str, index) -> str:
    """The reference's shard-hash key: the tag and, per dimension, the
    (start, stop) of the shard's global slice ((None, None) when whole)."""
    return f"{tag}|{[(sl.start, sl.stop) for sl in index]}"


def _shard_hashes(mesh, groups, tag: str, x: torch.Tensor, n: int,
                  lead: bool) -> dict:
    """{key: sha1} of this rank's shard of a flat state entry, keyed as the
    reference keys its output: a [W, N] entry (`lead`) by the [W, n] block
    of the rank's shard chunk (the worker group's rows gathered), an [N]
    one by its chunk; a chunk of S = 1 is the whole (None, None)."""
    s = groups.shard_index
    chunk = (slice(s * n, (s + 1) * n) if groups.n_shards > 1
             else slice(None, None))
    if lead:
        rows = mesh.all_gather(x.reshape(-1), groups.worker)
        x, index = rows.reshape(groups.n_workers, -1), (slice(None), chunk)
    else:
        index = (chunk,)
    return {_key(tag, index): hashlib.sha1(_bytes(x)).hexdigest()}


def _rank_slices(groups, spec, b: str, lead: bool):
    n = spec.buffer_size(b) // groups.n_shards
    chunk = slice(groups.shard_index * n, (groups.shard_index + 1) * n)
    if lead:
        w = groups.worker_index
        return (slice(w, w + 1), chunk)
    return (chunk,)


def _make_mesh(mesh: str, backend: str | None, device):
    from repro_torch.launch.mesh import Mesh
    dims, axes = _parse_mesh(mesh)
    if not dist.is_initialized():
        raise ConfigError(
            f"--mesh {mesh} runs one process per rank: start "
            f"{int(np.prod(dims))} with --spawn or the REPRO_* environment")
    return Mesh(dims, axes, backend=backend, device=device)


def _launches() -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels import sync_update as su
    return {"launches": {k: v for k, v in ops.launch_counts().items() if v},
            "bf16_launches": {"sync_flat_update":
                              su.sync_flat_update.bf16_launches,
                              "sync_apply_update":
                              su.sync_apply_update.bf16_launches}}


def run_sync(*, mesh: str = "2x2", policy: str = "dp",
             quantize: bool = True, momentum: float = 0.0,
             overlap: bool = False, rounds: int = 3, seed: int = 0,
             wire: str = "auto", membership: str = "",
             backend: str | None = None, device=None) -> dict:
    """`rounds` sharded syncs on the mesh of ranks, each rank's chunks
    asserted against the mesh-less host path (every rank runs it whole, on
    its own device: the flat sync kernels on the card).  Each round adds
    seeded numpy noise (the reference's draws) to every worker's params,
    then syncs; `overlap` issues the reduce at the round boundary and
    applies it in the next round, `membership` ("1,1,0,1") runs the partial
    sync (quantized: the consensus also against a run over the participant
    rows alone, `participant_exact`).  Bitwise when quantized and for 2
    workers unquantized; the ring wire within `ring_tolerance` after a
    per-element allowance of one output-dtype quantum a round, as the
    reference holds it.  The digest is over the host reference, gated on
    `ok`, as the reference's."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import flat as F
    from repro_torch.core.flat import dtype_name
    from repro_torch.core.sync import (make_sync, make_sync_apply,
                                       make_sync_begin, make_sync_partial,
                                       ring_tolerance, wire_dtype)
    from repro_torch.kernels import ops
    from repro_torch.models import param as pm

    m = _make_mesh(mesh, backend, device)
    dev = m.device
    if membership and (overlap or wire == "ring-int8"):
        raise ValueError("--membership composes with neither --overlap nor "
                         "the ring wire (run_sync docstring)")
    run_cfg = RunConfig(sharding=policy, sync_quantize=quantize,
                        outer_momentum=momentum, sync_wire=wire)
    w = pm.worker_count(policy, m)
    waxes = pm.worker_mesh_axes(policy, m)
    g = m.groups(waxes)
    saxes = g.shard_axes
    shards = m.size

    params = _demo_params(seed)
    spec_m = F.ShardedFlatSpace(params, shards, mesh=m, worker_axes=waxes,
                                shard_axes=saxes)
    spec_h = F.ShardedFlatSpace(params, shards)
    on_dev = {k: v.to(dev) for k, v in params.items()}
    stacked = {k: v[None].expand((w,) + tuple(v.shape)).contiguous()
               for k, v in on_dev.items()}
    base = {"params": spec_h.flatten(stacked, lead=1)}
    if quantize or momentum > 0.0:
        base["anchor"] = spec_h.flatten(on_dev)
    if momentum > 0.0:
        base["outer_mu"] = {b: torch.zeros(spec_h.buffer_size(b),
                                           dtype=torch.float32, device=dev)
                            for b in spec_h.buckets}
    take = lambda k, b, x: x[_rank_slices(g, spec_h, b, k == "params")]  # noqa: E731
    st_m = {k: {b: take(k, b, x).contiguous() for b, x in v.items()}
            for k, v in base.items()}
    st_h = {k: dict(v) for k, v in base.items()}

    rng = np.random.RandomState(seed + 1)
    noises = [{k: (rng.randn(w, *v.shape) * 0.01).astype(np.float32)
               for k, v in params.items()} for _ in range(rounds)]

    def steps(state, nb):
        return dict(state, params={
            b: state["params"][b] + nb[b].to(state["params"][b].dtype)
            for b in state["params"]})

    mask = (torch.tensor([float(x) for x in membership.split(",")],
                         dtype=torch.float32, device=dev)
            if membership else None)
    if mask is not None and mask.shape != (w,):
        raise ValueError(f"--membership needs {w} entries, got {membership!r}")

    if overlap:
        begin_m, apply_m = (make_sync_begin(run_cfg, spec_m),
                            make_sync_apply(run_cfg, spec_m))
        begin_h, apply_h = (make_sync_begin(run_cfg, spec_h),
                            make_sync_apply(run_cfg, spec_h))
    elif mask is not None:
        part_m = make_sync_partial(run_cfg, spec_m)
        part_h = make_sync_partial(run_cfg, spec_h)
        sync_m = lambda st: part_m(st, mask)  # noqa: E731
        sync_h = lambda st: part_h(st, mask)  # noqa: E731
    else:
        sync_m, sync_h = make_sync(run_cfg, spec_m), make_sync(run_cfg, spec_h)

    ops.reset_launch_counts()
    m.stats.reset()
    pend_m = pend_h = None
    with torch.no_grad():
        for noise in noises:
            nb = spec_h.flatten({k: torch.from_numpy(v).to(dev)
                                 for k, v in noise.items()}, lead=1)
            nb_m = {b: take("params", b, x) for b, x in nb.items()}
            if overlap:
                if pend_m is not None:
                    st_m, st_h = apply_m(st_m, pend_m), apply_h(st_h, pend_h)
                st_m, st_h = steps(st_m, nb_m), steps(st_h, nb)
                pend_m, pend_h = begin_m(st_m), begin_h(st_h)
            else:
                st_m, st_h = steps(st_m, nb_m), steps(st_h, nb)
                st_m, st_h = sync_m(st_m), sync_h(st_h)
        if overlap and pend_m is not None:
            st_m, st_h = apply_m(st_m, pend_m), apply_h(st_h, pend_h)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wire_stats = {"calls": dict(m.stats.calls),
                  "wire_bytes": dict(m.stats.wire_bytes),
                  "staging_s": m.stats.staging_s}
    counts = _launches()

    participant_exact = None
    if mask is not None and quantize:
        rows = [i for i in range(w) if mask[i]]
        wp = len(rows)
        spec_p = F.ShardedFlatSpace(params, wp)
        st_p = {"params": spec_p.flatten(
                    {k: v[None].expand((wp,) + tuple(v.shape)).contiguous()
                     for k, v in on_dev.items()}, lead=1),
                "anchor": spec_p.flatten(on_dev)}
        if momentum > 0.0:
            st_p["outer_mu"] = {b: torch.zeros(spec_p.buffer_size(b),
                                               dtype=torch.float32,
                                               device=dev)
                                for b in spec_p.buckets}
        part_p = make_sync_partial(run_cfg, spec_p)
        ones = torch.ones(wp, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for noise in noises:
                nb = spec_p.flatten({k: torch.from_numpy(v[rows]).to(dev)
                                     for k, v in noise.items()}, lead=1)
                st_p = part_p(steps(st_p, nb), ones)
        full = spec_h.unflatten(st_h["params"], lead=1)
        part = spec_p.unflatten(st_p["params"], lead=1)
        participant_exact = all(bool(torch.equal(full[k][0], part[k][0]))
                                for k in full)

    max_diff, excess, hashes = 0.0, 0.0, {}
    for k in sorted(st_h):
        for b in sorted(st_h[k]):
            lead = k == "params"
            ref = take(k, b, st_h[k][b]).float()
            got = st_m[k][b].float()
            eps = (2.0 ** -7 if st_h[k][b].dtype == torch.bfloat16
                   else 2.0 ** -23) * rounds
            if got.numel():
                d = (got - ref).abs()
                max_diff = max(max_diff, float(d.max()))
                excess = max(excess, float((d - ref.abs() * eps).max()))
            n = spec_h.buffer_size(b) // g.n_shards
            hashes.update(_shard_hashes(m, g, f"{k}/{b}", st_m[k][b], n,
                                        lead))
    if wire == "ring-int8":
        amax_d = max(float(np.max(np.abs(v)))
                     for nz in noises for v in nz.values())
        tol = ring_tolerance(w, amax_d, rounds)
        ok = excess <= tol
    else:
        tol = 0.0
        ok = max_diff == 0.0 and participant_exact is not False
    digest = (_digest([st_h[k][b] for k in sorted(st_h)
                       for b in sorted(st_h[k])])
              if ok else f"MISMATCH:{max_diff:.3e}")
    return {
        "mode": "sync", "ok": ok, "max_abs_diff": max_diff,
        "digest": digest, "shard_hashes": hashes,
        "mesh": mesh, "policy": policy, "workers": w, "shards": shards,
        "quantize": quantize, "momentum": momentum, "overlap": overlap,
        "membership": membership, "participant_exact": participant_exact,
        "rounds": rounds, "wire": wire, "ring_tol": tol,
        "wire_dtype": ("int8" if wire == "ring-int8" else
                       dtype_name(wire_dtype(w)) if quantize else "float32"),
        "device": str(dev), "mesh_stats": wire_stats, **counts,
        **runtime_info(),
    }


def run_engine(*, mesh: str = "2x2", policy: str = "dp",
               quantize: bool = True, momentum: float = 0.0,
               rounds: int = 3, seed: int = 0, arch: str = "starcoder2-3b",
               sync: str = "blocking", overlap_depth: int = 0,
               wire: str = "auto", backend: str | None = None,
               device=None) -> dict:
    """Full RoundEngine rounds on the mesh of ranks (the reference's recipe:
    the smoke config, AdamW under QSR, W from the policy, 2 sequences of 16
    tokens a worker on host data), against the port's single-process
    mesh-less engine at the same W (layout flat_sharded, as many shards as
    ranks), which every rank also runs: its chunks after the flush are
    held bitwise to the reference engine's (quantized, or 2 workers), and
    within 1e-6 for an overlap depth > 0 (the correction form).  Under
    sync="overlap" a blocking mesh engine runs beside it: at depth 0 the
    two are bitwise (`overlap_matches_blocking`).  Every rank reports the
    round losses, all-reduced over the worker group."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import schedules
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.sync import ring_tolerance
    from repro_torch.models import param as pm
    from repro_torch.optim.lr import make_lr_fn

    m = _make_mesh(mesh, backend, device)
    cfg = R.get_smoke_config(arch)
    run_cfg = RunConfig(schedule="qsr", optimizer="adamw",
                        total_steps=2 * rounds, peak_lr=3e-3, end_lr=1e-6,
                        warmup_steps=1, h_base=2, alpha=0.001, remat=False,
                        weight_decay=0.01, sync_quantize=quantize,
                        outer_momentum=momentum, sharding=policy,
                        sync_wire=wire)
    w = pm.worker_count(policy, m)
    mk = lambda s, d, mesh_=m: RoundEngine(  # noqa: E731
        cfg, run_cfg, workers=w, b_loc=2, seq=16, seed=seed, data="host",
        layout="flat_sharded", sync=s, overlap_depth=d, mesh=mesh_,
        policy=policy, shards=m.size, device=m.device)
    eng = mk(sync, overlap_depth)
    blk = mk("blocking", 0) if sync == "overlap" else None
    single = mk(sync, overlap_depth, None)
    lr_fn = make_lr_fn(run_cfg)
    state, s_state = eng.init_state(), single.init_state()
    b_state = blk.init_state() if blk else None
    losses, single_losses, blk_losses, tol = [], [], [], 0.0
    for t, h in schedules.rounds(run_cfg, lr_fn):
        state, mt = eng.run_round(state, t, h, lr_fn)
        losses.append(float(mt["loss"]))
        s_state, ms = single.run_round(s_state, t, h, lr_fn)
        single_losses.append(float(ms["loss"]))
        if blk:
            b_state, mb = blk.run_round(b_state, t, h, lr_fn)
            blk_losses.append(float(mb["loss"]))
        if wire == "ring-int8":
            tol += ring_tolerance(w, 4.0 * h * run_cfg.peak_lr, 1)
    state, s_state = eng.flush(state), single.flush(s_state)
    g = m.groups(eng.spec.worker_axes)

    def diff(a_state, ref_state, rank_ref: bool) -> float:
        out = 0.0
        for k in ("params", "anchor"):
            for b in a_state.get(k, {}):
                ref = ref_state[k][b]
                if not rank_ref:
                    ref = ref[_rank_slices(g, eng.spec, b, k == "params")]
                out = max(out, float((a_state[k][b].float()
                                      - ref.float()).abs().max()))
        return out

    vs_single = diff(state, s_state, False)
    exact = quantize or w == 2
    if wire == "ring-int8":
        matches_single = vs_single <= tol
    elif overlap_depth > 0:
        matches_single = vs_single <= 1e-6
    else:
        matches_single = vs_single == 0.0 if exact else vs_single <= 1e-6
    hashes = {}
    for k in ("params", "anchor"):
        for b, x in state.get(k, {}).items():
            n = eng.spec.buffer_size(b) // g.n_shards
            hashes.update(_shard_hashes(m, g, f"{k}/{b}", x, n,
                                        k == "params"))
    ok = bool(np.all(np.isfinite(losses))) and matches_single
    rec = {}
    if blk:
        vs_blk = diff(state, blk.flush(b_state), True)
        matches = vs_blk <= tol if wire == "ring-int8" else vs_blk == 0.0
        if overlap_depth == 0:
            ok = ok and matches
        rec = {"blocking_losses": blk_losses,
               "overlap_matches_blocking": matches,
               "max_abs_diff_vs_blocking": vs_blk, "wire_tolerance": tol}
    return {
        "mode": "engine", "ok": ok, "losses": losses,
        "single_process_losses": single_losses,
        "max_abs_diff_vs_single_process": vs_single,
        "matches_single_process": matches_single,
        "shard_hashes": hashes, "mesh": mesh, "policy": policy,
        "workers": w, "quantize": quantize, "momentum": momentum,
        "rounds": len(losses), "sync": sync, "overlap_depth": overlap_depth,
        "wire": wire, "arch": arch, "device": str(m.device), **rec,
        **runtime_info(),
    }


def probe(*, backend: str | None = None, device=None) -> dict:
    """Every collective verb once, on device tensors where the mesh's are:
    over the world (its ranks in a 1-D mesh) and, on an even world, over
    the 2-rank groups of a (world/2) x 2 mesh.  Each result is checked
    against its value computed locally: the world's SUM of the ranks (the
    reference's probe), a float32 reduce-scatter, an all-gather, a MAX, an
    int16 reduce-scatter (the ring of int8 views) and all-gather, and one
    ring shift."""
    from repro_torch.launch.mesh import Mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized():
        raise ConfigError("probe runs on an initialized process group")
    meshes = [Mesh((n,), ("data",), backend=backend, device=device)]
    if n % 2 == 0 and n > 2:
        meshes.append(Mesh((n // 2, 2), ("data", "model"), backend=backend,
                           device=device))
    checks, stats = {}, []
    for m in meshes:
        split = m.groups(m.axis_names[-1:])
        grp = split.world if len(m.dims) == 1 else split.worker
        dev, g, i = m.device, grp.size, grp.index
        r = dist.get_rank()
        tag = f"{'x'.join(map(str, m.dims))}/g{g}"
        total = m.all_reduce(torch.tensor([float(r)], device=dev), "sum",
                             split.world)
        checks[f"{tag}/sum"] = float(total[0]) == n * (n - 1) / 2
        base = torch.arange(4 * g, dtype=torch.float32, device=dev)
        rs = m.reduce_scatter_sum(base + i, grp)
        want = (base.view(g, 4)[i] * g + sum(range(g)))
        checks[f"{tag}/reduce_scatter"] = bool(torch.equal(rs, want))
        ag = m.all_gather(torch.full((3,), float(i), device=dev), grp)
        checks[f"{tag}/all_gather"] = bool(torch.equal(
            ag, torch.arange(g, device=dev).float().repeat_interleave(3)))
        mx = m.all_reduce(torch.tensor([float(i), -float(i)], device=dev),
                          "max", grp)
        checks[f"{tag}/max"] = mx.tolist() == [float(g - 1), 0.0]
        codes = (torch.arange(6 * g, device=dev) % 255 - 127).to(torch.int16)
        rs16 = m.reduce_scatter_sum(codes * (i + 1), grp)
        want16 = codes.view(g, 6)[i] * sum(range(1, g + 1))
        checks[f"{tag}/int16_reduce_scatter"] = (
            rs16.dtype == torch.int16 and bool(torch.equal(rs16, want16)))
        ag16 = m.all_gather(codes.view(g, 6)[i].contiguous(), grp)
        checks[f"{tag}/int16_all_gather"] = bool(torch.equal(ag16, codes))
        sh = m.ring_shift(torch.full((5,), i, dtype=torch.int8, device=dev),
                          grp)
        checks[f"{tag}/ring_shift"] = bool(torch.equal(
            sh, torch.full((5,), (i - 1) % g, dtype=torch.int8, device=dev)))
        stats.append({"mesh": tag, "calls": dict(m.stats.calls),
                      "wire_bytes": dict(m.stats.wire_bytes),
                      "staging_s": m.stats.staging_s})
    return {"mode": "probe", "ok": all(checks.values()), "checks": checks,
            "devices": n, "device": str(meshes[0].device),
            "mesh_stats": stats, **runtime_info()}


# --------------------------------------------------------------------------
# Elastic rounds and fault injection (module docstring)
# --------------------------------------------------------------------------

class Heartbeat:
    """File-based liveness detector for lockstep round workers.

    Entering round r, every worker `announce(r)`s a heartbeat file, then
    `await_peers(r)` polls for all peers' files under a bounded timeout.
    A dead worker cannot announce, so the survivors learn of the loss
    before entering the round's collectives — the only safe moment: one
    dead gloo member stalls every collective until the group's timeout.
    Workers are in lockstep (the previous round ended in a barrier), so a
    missing heartbeat after `timeout` means dead or hopelessly straggling;
    the verdict is the same either way: leave the generation and let the
    controller respawn the survivors."""

    def __init__(self, path: str, pid: int, nprocs: int, *,
                 timeout: float = 30.0, poll: float = 0.05):
        self.path, self.pid, self.n = path, pid, nprocs
        self.timeout, self.poll = timeout, poll
        os.makedirs(path, exist_ok=True)

    def _f(self, rnd: int, pid: int) -> str:
        return os.path.join(self.path, f"hb-{rnd:06d}-{pid:05d}")

    def announce(self, rnd: int) -> None:
        with open(self._f(rnd, self.pid), "w") as f:
            f.write(f"{time.time()}")

    def await_peers(self, rnd: int) -> list[int]:
        """Block until every peer announced round `rnd` or the timeout
        lapses; returns the pids still missing (empty: proceed)."""
        deadline = time.monotonic() + self.timeout
        missing = [p for p in range(self.n) if p != self.pid]
        while missing and time.monotonic() < deadline:
            missing = [p for p in missing
                       if not os.path.exists(self._f(rnd, p))]
            if missing:
                time.sleep(self.poll)
        return [p for p in missing if not os.path.exists(self._f(rnd, p))]


def _parse_chaos(spec: str):
    """'kill:worker=2,round=1' -> ('kill', {'worker': 2, 'round': 1})."""
    if not spec:
        return None, {}
    kind, _, rest = spec.partition(":")
    kv = {}
    for part in rest.split(","):
        if part:
            a, _, b = part.partition("=")
            kv[a.strip()] = int(b)
    return kind, kv


def _elastic_state_arrays(state):
    """(tag, buffer) over the whole flat state: params, anchor, outer
    momentum, then the optimizer's per-lane moments."""
    for k in ("params", "anchor", "outer_mu"):
        if k in state:
            for b, arr in state[k].items():
                yield f"{k}/{b}", arr
    for k in ("m", "v", "mu"):
        for b, arr in (state.get("opt") or {}).get(k, {}).items():
            yield f"opt.{k}/{b}", arr


def _elastic_pieces(eng, state):
    """(key, tensor) of every shard unit the reference's generation holds,
    keyed as the reference keys a device's shard: a mesh rank's own chunks;
    a mesh-less engine's W lanes as the ranks of a W x 1 mesh hold them (a
    [W, N] buffer's lane rows, an [N] buffer whole).  A dimension split in
    one part is (None, None), as JAX indexes it."""
    from repro_torch.core import flat as F
    if eng.mesh is not None:
        g = eng._groups
        units = [(g.worker_index, g.shard_index, g.n_workers, g.n_shards,
                  state)]
    else:
        units = [(w, 0, eng.workers, 1, F.take_slices(
            state, F.flat_state_slices(eng.run_cfg, eng.spec, w, 0, 1)))
            for w in range(eng.workers)]
    out = []
    for w, s, n_w, n_s, st in units:
        for tag, arr in _elastic_state_arrays(st):
            c = arr.shape[-1]
            chunk = slice(s * c, (s + 1) * c) if n_s > 1 else slice(None)
            index = ((slice(w, w + 1) if n_w > 1 else slice(None), chunk)
                     if arr.ndim == 2 else (chunk,))
            out.append((_key(tag, index), arr))
    return out


def _elastic_hashes(eng, state) -> dict:
    """Shard hashes over the whole flat state — params, anchor, and the
    per-lane Adam moments / outer momentum: a restore or trajectory fault
    hiding in the moments would otherwise show only as a slow drift."""
    return {k: hashlib.sha1(_bytes(x)).hexdigest()
            for k, x in _elastic_pieces(eng, state)}


def _elastic_norms(eng, state) -> dict:
    """{shard key: [l2, absmax]} in float64 over the same units as
    `_elastic_hashes`: the tolerance comparison where bitwise is not the
    contract."""
    out = {}
    for k, x in _elastic_pieces(eng, state):
        a = x.detach().double()
        out[k] = [float(torch.sqrt(torch.sum(a * a))),
                  float(a.abs().max()) if a.numel() else 0.0]
    return out


def norms_close(a: dict, b: dict, *, rtol: float = 1e-5) -> bool:
    """Same shard keys, every [l2, absmax] pair within rtol (relative to
    the larger magnitude, floored at 1.0 so zero buckets compare sanely)."""
    if a is None or b is None or not a or set(a) != set(b):
        return False
    for k in a:
        for x, y in zip(a[k], b[k]):
            if abs(x - y) > rtol * max(abs(x), abs(y), 1.0):
                return False
    return True


def run_elastic_worker(*, rounds: int, start_round: int = 0, workdir: str,
                       chaos: str = "", quantize: bool = True,
                       momentum: float = 0.0, seed: int = 0,
                       arch: str = "starcoder2-3b",
                       heartbeat_timeout: float = 30.0, lanes: int = 1,
                       backend: str | None = None, device=None) -> dict:
    """One worker of one elastic generation.  On an initialized process
    group of L ranks: one rank of an L x 1 dp mesh (W = L lanes, one a
    process); without one: the whole generation in this process, the
    mesh-less engine at W = `lanes`, which holds every rank's chunks (the
    reference's one-process run over L devices).  The reference's recipe:
    the smoke config, AdamW, layout flat_sharded, sync "partial", device
    data, 2 steps a round, a manifest checkpoint at every round boundary
    (and, in one process, the monolithic twin in `ckpt-mono`).

    start_round > 0 resumes from the workdir's manifest through
    `restore_elastic`, written under any earlier worker count: a shrunk
    generation drops the dead lane, a regrown one clones the consensus into
    the rejoined lane.  start_round == rounds runs no round: the restore
    and hash probe.

    chaos="kill:worker=k,round=r": rank k leaves with `os._exit(7)` at the
    start of round r, before announcing its heartbeat; the survivors'
    `await_peers` times out and each returns the membership verdict
    (status "membership-change": the missing ranks and the resume point),
    on which the CLI exits 3."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.engine import RoundEngine
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.lr import make_lr_fn

    mesh = None
    if dist.is_initialized():
        workers = dist.get_world_size()
        mesh = Mesh((workers, 1), ("data", "model"), backend=backend,
                    device=device)
    else:
        workers = int(lanes)
    cfg = R.get_smoke_config(arch)
    run_cfg = RunConfig(schedule="constant", optimizer="adamw",
                        total_steps=2 * max(rounds, 1), peak_lr=3e-3,
                        warmup_steps=1, h_base=2, remat=False,
                        weight_decay=0.01, sync_quantize=quantize,
                        outer_momentum=momentum, sharding="dp")
    eng = RoundEngine(cfg, run_cfg, workers=workers, b_loc=2, seq=16,
                      seed=seed, data="device", layout="flat_sharded",
                      sync="partial", mesh=mesh, policy="dp",
                      device=None if mesh is not None else device)
    lr_fn = make_lr_fn(run_cfg)
    state = eng.init_state()
    ckpt = os.path.join(workdir, "ckpt")
    if start_round > 0:
        state, step = eng.restore_elastic(ckpt, state)
        if step != 2 * start_round:
            raise RuntimeError(
                f"manifest at {ckpt} resumes at step {step}, this "
                f"generation starts at round {start_round} (step "
                f"{2 * start_round})")
    pid = mesh.rank if mesh is not None else 0
    nproc = mesh.size if mesh is not None else 1
    kind, kv = _parse_chaos(chaos)
    kill = ((kv.get("worker", -1), kv.get("round", -1))
            if kind == "kill" else None)
    # a heartbeat directory a generation: a stale announcement from an
    # earlier one must not vouch for a rank that died in this one
    hb = Heartbeat(os.path.join(workdir, f"hb-e{start_round}x{nproc}"),
                   pid, nproc, timeout=heartbeat_timeout)
    losses = []
    for r in range(start_round, rounds):
        if kill == (pid, r):
            sys.stdout.flush()
            os._exit(7)       # the chaos monkey: no goodbye, no heartbeat
        hb.announce(r)
        missing = hb.await_peers(r)
        if missing:
            return {"mode": "elastic", "status": "membership-change",
                    "ok": True, "missing": missing, "resume_round": r,
                    "resume_step": 2 * r, "checkpoint": ckpt,
                    "rounds_done": r - start_round, **_launches(),
                    **runtime_info()}
        state, m = eng.run_round(state, 2 * r, 2, lr_fn)
        losses.append(float(m["loss"]))
        eng.save_sharded(ckpt, state, step=2 * (r + 1))
        if mesh is None:
            eng.save(os.path.join(workdir, "ckpt-mono"), state,
                     step=2 * (r + 1))
    return {"mode": "elastic", "status": "complete",
            "ok": bool(np.all(np.isfinite(losses))) if losses else True,
            "losses": losses, "shard_hashes": _elastic_hashes(eng, state),
            "shard_norms": _elastic_norms(eng, state),
            "workers": workers, "rounds": rounds,
            "start_round": start_round, "checkpoint": ckpt,
            "device": str(eng.device), **_launches(), **runtime_info()}


def _sum_launches(records) -> dict:
    """The kernels' launches summed over a generation's records."""
    out: dict = {}
    for rec in records:
        for k, v in ((rec or {}).get("launches") or {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _epoch_results(results):
    """One generation's per-process (rc, stdout, stderr): the last JSON
    line of each stdout, their merged shard hashes and norms, the rcs."""
    parsed, hashes, norms = [], {}, {}
    for _, so, _ in results:
        rec = last_json(so)
        parsed.append(rec)
        if rec:
            hashes.update(rec.get("shard_hashes") or {})
            norms.update(rec.get("shard_norms") or {})
    return parsed, hashes, norms, [rc for rc, _, _ in results]


def run_elastic(num_workers: int, *, rounds: int = 3, chaos: str,
                seed: int = 0, arch: str = "starcoder2-3b",
                quantize: bool = True, momentum: float = 0.0,
                workdir: str | None = None,
                heartbeat_timeout: float = 30.0, timeout: float = 900,
                extra_rounds: int = 2, device: str = "cuda",
                backend: str = "gloo") -> dict:
    """The fault-injection controller: drives worker generations (a gloo
    group cannot resize in place, so each worker set is one generation of
    processes) through a kill-and-recover story, holding each generation of
    ranks against one process running the same lanes.

    --chaos kill:worker=k,round=r
      gen 0 (W ranks):   rounds 0..r-1 complete; rank k dies at the start
                         of round r; the survivors' heartbeat timeout
                         fires and they exit 3 with the verdict
      gen 1 (W-1 ranks): resumes round r from the last round-boundary
                         manifest and completes the run; its consensus
                         (params + anchor) bitwise a one-process (W-1)-lane
                         run resuming the same manifest (the quantized
                         partial mean is exact in integer codes), the Adam
                         moments within the norms tolerance
    --chaos preempt-restore[:worker=k,round=r]
      ...then gen 2 (W ranks again) rejoins the lost lane from gen 1's
      final manifest (a W-lane restore of a (W-1)-lane checkpoint under
      another process count; the rejoined lane clones the consensus) and
      runs `extra_rounds` more, held within the norms (1e-5) and losses
      (1e-4) tolerance of a one-process W-lane run; bitwise is reported.

    Each reference generation runs in a copy of the workdir (the live one
    advances the rolling checkpoint), beside its live generation.  The
    ranks and the one-process runs are on `device` ("cuda": every rank on
    the one card over `backend`).  Returns the recovery telemetry (the
    reference's keys)."""
    import concurrent.futures
    import shutil

    kind, kv = _parse_chaos(chaos)
    if kind not in ("kill", "preempt-restore"):
        raise ValueError(f"unknown chaos spec {chaos!r}")
    k = kv.get("worker", num_workers // 2)
    r = kv.get("round", 1)
    if not (0 <= k < num_workers and 0 < r < rounds):
        raise ValueError(f"chaos worker={k}, round={r} out of range for "
                         f"{num_workers} workers x {rounds} rounds")
    workdir = workdir or tempfile.mkdtemp(prefix="repro-torch-elastic-")
    os.makedirs(workdir, exist_ok=True)

    def fork(name: str) -> str:
        dst = os.path.join(workdir, name)
        os.makedirs(dst, exist_ok=True)
        if os.path.isdir(os.path.join(workdir, "ckpt")):
            shutil.copytree(os.path.join(workdir, "ckpt"),
                            os.path.join(dst, "ckpt"), dirs_exist_ok=True)
        return dst

    def gen(lanes: int, total_rounds: int, start: int, *, one: bool = False,
            chaos_arg: str = "", wd: str | None = None):
        ex = ["--mode", "elastic", "--rounds", str(total_rounds),
              "--start-round", str(start), "--workdir", wd or workdir,
              "--momentum", str(momentum), "--seed", str(seed),
              "--arch", arch, "--heartbeat-timeout", str(heartbeat_timeout),
              "--device", device, "--backend", backend]
        if quantize:
            ex.append("--quantize")
        if chaos_arg:
            ex += ["--chaos", chaos_arg]
        if one:
            ex += ["--total-devices", str(lanes)]
        return _epoch_results(spawn_workers(
            1 if one else lanes, extra=tuple(ex), timeout=timeout,
            distributed=not one))

    def pair(lanes: int, total_rounds: int, start: int, ref_wd: str):
        """The live generation and its one-process reference, together."""
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ref = pool.submit(gen, lanes, total_rounds, start, one=True,
                              wd=ref_wd)
            live = gen(lanes, total_rounds, start)
            return live, ref.result()

    out = {"mode": "elastic-controller", "chaos": chaos, "workers":
           num_workers, "rounds": rounds, "kill": {"worker": k, "round": r},
           "workdir": workdir, "device": device, "generations": []}

    # generation 0: the full worker set, one rank killed mid-run
    t0 = time.perf_counter()
    p0, _, _, rc0 = gen(num_workers, rounds, 0,
                        chaos_arg=f"kill:worker={k},round={r}")
    verdicts = [x for x in p0 if x and x.get("status") == "membership-change"]
    detect_ok = (
        rc0[k] == 7
        and all(rc == 3 for i, rc in enumerate(rc0) if i != k)
        and len(verdicts) == num_workers - 1
        and all(v["missing"] == [k] and v["resume_round"] == r
                for v in verdicts))
    out["generations"].append({"lanes": num_workers, "rcs": rc0,
                               "verdicts": verdicts, "detect_ok": detect_ok,
                               "launches": _sum_launches(p0),
                               "seconds": time.perf_counter() - t0})
    if not detect_ok:
        out["ok"] = False
        return out

    # generation 1: the survivors complete the run on the reduced mesh,
    # bitwise a one-process run resuming the same manifest
    lanes1 = num_workers - 1
    t0 = time.perf_counter()
    (p1, h1, n1, rc1), (pr, hr, nr, rcr) = pair(lanes1, rounds, r,
                                                fork("ref1"))
    # the bitwise claim is the partial-mean consensus (params + anchor:
    # integer codes); the lane-local Adam moments are held within the norms
    # tolerance, as the reference holds them
    cons = lambda h: {key: v for key, v in h.items()  # noqa: E731
                      if not key.startswith("opt.")}
    recover_ok = (all(rc == 0 for rc in rc1 + rcr) and bool(h1)
                  and cons(h1) == cons(hr) and norms_close(n1, nr))
    out["generations"].append({
        "lanes": lanes1, "rcs": rc1, "reference_rcs": rcr,
        "rounds_redone": rounds - r,
        "losses": next((x.get("losses") for x in p1 if x), None),
        "reference_losses": next((x.get("losses") for x in pr if x), None),
        "bitwise_vs_single_process": cons(h1) == cons(hr),
        "moments_tolerance_ok": norms_close(n1, nr),
        "shards_compared": len(h1), "launches": _sum_launches(p1),
        "reference_launches": _sum_launches(pr),
        "seconds": time.perf_counter() - t0})
    ok = detect_ok and recover_ok

    if kind == "preempt-restore" and ok:
        # generation 2: the lost lane rejoins from gen 1's final manifest,
        # held within the tolerance bound (the restore itself is bitwise:
        # the manifest tests); bitwise is reported beside it
        total2 = rounds + extra_rounds
        t0 = time.perf_counter()
        (p2, h2, n2, rc2), (pr2, hr2, nr2, rcr2) = pair(
            num_workers, total2, rounds, fork("ref2"))
        l2 = next((x.get("losses") for x in p2 if x), None)
        lr2 = next((x.get("losses") for x in pr2 if x), None)
        losses_ok = (l2 is not None and lr2 is not None and len(l2) == len(lr2)
                     and all(abs(a - b) <= 1e-4 * max(abs(a), abs(b), 1.0)
                             for a, b in zip(l2, lr2)))
        rejoin_ok = (all(rc == 0 for rc in rc2 + rcr2)
                     and norms_close(n2, nr2) and losses_ok)
        out["generations"].append({
            "lanes": num_workers, "rcs": rc2, "reference_rcs": rcr2,
            "rejoined_from": "manifest", "extra_rounds": extra_rounds,
            "losses": l2, "reference_losses": lr2,
            "tolerance_vs_single_process": rejoin_ok,
            "bitwise_vs_single_process": h2 == hr2,
            "shards_compared": len(n2), "launches": _sum_launches(p2),
            "reference_launches": _sum_launches(pr2),
            "seconds": time.perf_counter() - t0})
        ok = ok and rejoin_ok

    out["ok"] = ok
    return out


# --------------------------------------------------------------------------
# Spawning
# --------------------------------------------------------------------------

def worker_argv(extra) -> list[str]:
    """The command line of one spawned rank: this module, run as a
    worker."""
    return [sys.executable, "-m", WORKER_MODULE, *extra]


def spawn_workers(num_processes: int, *, extra=(), timeout: float = 900,
                  store_dir: str | None = None, env: dict | None = None,
                  argv=None, distributed: bool = True):
    """Launch `num_processes` ranks of this module (or of the command
    `argv`) on this machine and wait for them; returns [(returncode,
    stdout, stderr)] per rank.  They meet at a file store in `store_dir` (a
    fresh temporary directory by default): no port to race for.  A rank
    still running after `timeout` seconds is killed, and so are the
    others: a spawn fails, it never hangs.  `distributed=False` starts one
    plain process, with no REPRO_* environment (a one-process run)."""
    if not distributed and num_processes != 1:
        raise ConfigError("a spawn without a process group is one process")
    tmp = None
    if store_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro-torch-mh-")
        store_dir = tmp.name
    os.makedirs(store_dir, exist_ok=True)    # a store in a missing one hangs
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs = []
    for pid in range(num_processes):
        e = dict(os.environ if env is None else env)
        if distributed:
            e["REPRO_COORDINATOR"] = f"file://{store}"
            e["REPRO_NUM_PROCESSES"] = str(num_processes)
            e["REPRO_PROCESS_ID"] = str(pid)
        else:
            for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                        "REPRO_PROCESS_ID"):
                e.pop(var, None)
        e["PYTHONPATH"] = _SRC + os.pathsep + e.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(argv or worker_argv(extra), env=e,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            try:
                so, se = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                so, se = p.communicate()
                se = (se or "") + "\n[spawn_workers] TIMEOUT"
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        if tmp is not None:
            tmp.cleanup()
    return out


def last_json(text: str):
    """The last line of `text` that parses as JSON, or None."""
    for line in reversed((text or "").strip().splitlines()):
        try:
            return json.loads(line)
        except (json.JSONDecodeError, ValueError):
            continue
    return None


def run_suite(configs, *, backend, device) -> dict:
    """Several configurations on one world, in order: each a dict with a
    "mode" ("sync", "engine" or "probe") and that mode's keyword
    arguments.  One process group serves them all: a chip run pays the
    ranks' start once."""
    fns = {"sync": run_sync, "engine": run_engine, "probe": probe}
    results = []
    for c in configs:
        c = dict(c)
        fn = fns[c.pop("mode")]
        results.append(fn(backend=backend, device=device, **c))
    return {"mode": "suite", "ok": all(r["ok"] for r in results),
            "results": results, **runtime_info()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="launch N ranks on this machine and print their "
                         "JSON (0: run as a rank)")
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "engine", "probe", "elastic", "suite",
                             "train"])
    ap.add_argument("--chaos", default="",
                    help="fault injection: 'kill:worker=K,round=R' or "
                         "'preempt-restore[:worker=K,round=R]'.  With "
                         "--spawn this runs the elastic controller across "
                         "worker generations; for a rank it names its own "
                         "death sentence")
    ap.add_argument("--workdir", default="",
                    help="elastic mode: the checkpoint and heartbeat "
                         "directory the generations share (default: a new "
                         "temporary directory)")
    ap.add_argument("--start-round", type=int, default=0,
                    help="elastic mode: the generation's first round (it "
                         "resumes the workdir's manifest when > 0)")
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0,
                    help="elastic mode: seconds before a silent peer is "
                         "declared dead at a round boundary")
    ap.add_argument("--total-devices", type=int, default=8,
                    help="elastic mode in one process: its lane count")
    ap.add_argument("--out", default="",
                    help="also write the result JSON here")
    ap.add_argument("--membership", default="",
                    help="sync mode: comma mask ('1,1,0,1') switching both "
                         "paths to the partial sync")
    ap.add_argument("--mesh", default="2x2",
                    help="data x model or pod x data x model; the product "
                         "is the number of ranks")
    ap.add_argument("--policy", default="dp", choices=["dp", "fsdp"])
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--wire", default="auto", choices=["auto", "ring-int8"])
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--overlap", action="store_true",
                    help="sync mode: split begin/apply across round "
                         "boundaries")
    ap.add_argument("--sync", default="blocking",
                    choices=["blocking", "overlap"])
    ap.add_argument("--overlap-depth", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="where each rank's tensors live (default: the "
                         "card; raises without one)")
    ap.add_argument("--suite", default="",
                    help="suite mode: a JSON list of configurations")
    ap.add_argument("--timeout", type=float, default=900,
                    help="--spawn: seconds before the ranks are killed")
    ap.add_argument("--store-dir", default=None,
                    help="--spawn: the directory of the ranks' file store")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="train mode: `-- <launch/train.py flags>`")
    args = ap.parse_args(argv)
    if args.wire == "ring-int8":
        args.quantize = True

    def emit(out: dict) -> None:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2)
        print(json.dumps(out), flush=True)

    if args.spawn and args.chaos:
        # the elastic controller: it only spawns generations and judges
        # their verdicts and hashes
        out = run_elastic(args.spawn, rounds=args.rounds, chaos=args.chaos,
                          seed=args.seed, arch=args.arch,
                          quantize=args.quantize, momentum=args.momentum,
                          workdir=args.workdir or None,
                          heartbeat_timeout=args.heartbeat_timeout,
                          timeout=args.timeout, device=args.device,
                          backend=args.backend)
        emit(out)
        sys.exit(0 if out["ok"] else 1)

    if args.spawn:
        extra = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = extra.index("--spawn")
        del extra[i:i + 2]
        if args.mode == "elastic" and not args.workdir:
            # the ranks share one checkpoint and heartbeat directory
            extra += ["--workdir", tempfile.mkdtemp(prefix="repro-el-")]
        results = spawn_workers(args.spawn, extra=tuple(extra),
                                timeout=args.timeout,
                                store_dir=args.store_dir)
        ok = all(rc == 0 for rc, _, _ in results)
        for i, (rc, so, se) in enumerate(results):
            print(f"--- process {i} (rc={rc}) ---")
            print(so.strip())
            if rc != 0:
                print(se[-4000:], file=sys.stderr)
        sys.exit(0 if ok else 1)

    initialize(backend=args.backend)
    if args.mode == "elastic":
        device = (rank_device(args.device, args.backend)
                  if dist.is_initialized() else args.device)
        out = run_elastic_worker(
            rounds=args.rounds, start_round=args.start_round,
            workdir=args.workdir or tempfile.mkdtemp(prefix="repro-el-"),
            chaos=args.chaos, quantize=args.quantize,
            momentum=args.momentum, seed=args.seed, arch=args.arch,
            heartbeat_timeout=args.heartbeat_timeout,
            lanes=args.total_devices, backend=args.backend, device=device)
        emit(out)
        if out.get("status") == "membership-change":
            # exit 3 is the membership verdict; os._exit skips the process
            # group's teardown, which would wait on the dead peer
            os._exit(3)
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.exit(0 if out["ok"] else 1)
    if args.mode == "train":
        from repro_torch.launch import train
        try:
            train.main([a for a in args.train_args if a != "--"])
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return
    try:
        device = (rank_device(args.device, args.backend)
                  if dist.is_initialized() else args.device)
        if args.mode == "probe":
            out = probe(backend=args.backend, device=device)
        elif args.mode == "suite":
            out = run_suite(json.loads(args.suite), backend=args.backend,
                            device=device)
        elif args.mode == "engine":
            out = run_engine(mesh=args.mesh, policy=args.policy,
                             quantize=args.quantize, momentum=args.momentum,
                             rounds=args.rounds, seed=args.seed,
                             arch=args.arch, sync=args.sync,
                             overlap_depth=args.overlap_depth, wire=args.wire,
                             backend=args.backend, device=device)
        else:
            out = run_sync(mesh=args.mesh, policy=args.policy,
                           quantize=args.quantize, momentum=args.momentum,
                           overlap=args.overlap, rounds=args.rounds,
                           seed=args.seed, wire=args.wire,
                           membership=args.membership, backend=args.backend,
                           device=device)
        emit(out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
