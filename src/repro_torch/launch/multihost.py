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

Not ported yet: `--mode elastic` and `--chaos`, which need the sharded
checkpoints (`save_sharded`).
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
# Spawning
# --------------------------------------------------------------------------

def worker_argv(extra) -> list[str]:
    """The command line of one spawned rank: this module, run as a
    worker."""
    return [sys.executable, "-m", WORKER_MODULE, *extra]


def spawn_workers(num_processes: int, *, extra=(), timeout: float = 900,
                  store_dir: str | None = None, env: dict | None = None,
                  argv=None):
    """Launch `num_processes` ranks of this module (or of the command
    `argv`) on this machine and wait for them; returns [(returncode,
    stdout, stderr)] per rank.  They meet at a file store in `store_dir` (a
    fresh temporary directory by default): no port to race for.  A rank
    still running after `timeout` seconds is killed, and so are the
    others: a spawn fails, it never hangs."""
    tmp = None
    if store_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro-torch-mh-")
        store_dir = tmp.name
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs = []
    for pid in range(num_processes):
        e = dict(os.environ if env is None else env)
        e["REPRO_COORDINATOR"] = f"file://{store}"
        e["REPRO_NUM_PROCESSES"] = str(num_processes)
        e["REPRO_PROCESS_ID"] = str(pid)
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
    ap.add_argument("--chaos", default="")
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
    if args.mode == "elastic" or args.chaos:
        raise ConfigError("--mode elastic and --chaos: not ported yet (they "
                          "need the sharded checkpoints, save_sharded)")

    if args.spawn:
        extra = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = extra.index("--spawn")
        del extra[i:i + 2]
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
        print(json.dumps(out), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
