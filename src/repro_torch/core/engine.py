"""RoundEngine: the runtime that owns state, data and telemetry for a
training run (port of `repro/core/engine.py`).

The reference compiles one XLA program per power-of-two bucket of H and
masks the padded steps; PyTorch runs eagerly, so the port runs exactly `h`
local steps and then the sync — the semantics the reference proves its
masked program equal to.  `mode` ("bucketed" | "legacy") is kept as a
checked argument only; there is nothing to compile or cache.

Telemetry per round, as the reference computes it: the loss and the
worker-mean global gradient norm, each averaged over the round's steps, and
the worker divergence `mean_i ||x_i - x_bar||_2` measured BEFORE the sync.
They stay 0-d device tensors (`run_round` returns them, `round_metrics`
keeps them); a caller reads them to the host once per round, not once per
step.

Layouts: "tree" (state mirrors the model tree), "flat" (one `[W, N]`
buffer per dtype bucket: one optimizer kernel launch per step and one sync
kernel launch per round per bucket; bitwise the tree trajectory) and
"flat_sharded" (the flat buckets zero-padded to a multiple of `shards`,
`core/flat.py ShardedFlatSpace`; without a mesh bitwise the flat layout).

On a mesh (`mesh=`, a `launch/mesh.py` Mesh, layout "flat_sharded"), the
engine is one rank of it, one process: it holds one worker's lane (worker
i, from the policy's worker axes) and only its chunk s of that lane's
params, m and v and of the anchor (1/S of each).  A local step gathers the
worker's buckets over the shard group, takes the gradient at W = 1 on lane
i of the batch and updates the rank's chunk (`make_mesh_local_step`); the
sync runs its collective halves (`core/sync.py`).  Lane i of a batch is
the single-process batch's lane, bit for bit: the built-in host stream
draws that lane alone, device data draws all W lanes and keeps lane i (W
times the draw), and a `batch_fn` returns either the reference's W lanes
`[W, B_loc, ...]` (lane i is kept) or the rank's lane `[1, B_loc, ...]`
itself (`vision_batch_fn(..., lanes=[i])`, taken as it is); any other lane
count raises ConfigError.  The round's loss, grad
norm and divergence are all-reduced over the worker group (the divergence
with one all-reduce of the params chunk).  `params_single` gathers worker
0 over the shard group.  Every rank computes its worker's whole step: the
reference's GSPMD splits a worker's compute over its shard group, the
port does not yet.  Data:
"host", from a `batch_fn(step) -> batch [W, B_loc, ...]` or, without one,
the built-in `TokenStream(vocab, seed)` through `make_train_batch`, as the
reference's host path draws it (CPU tensors, moved to the run's device
here); "device", drawn on the run's device by `device_batch_fn` from the
same stream's transition table, as the reference's device path (no host
stack, no host-to-device copy); `data_seconds` accumulates the host time
spent drawing batches (for device data, the time to issue the draw).

Sync modes:
  * "blocking": every round ends fully synced.
  * "overlap": a round ends with the reduce half only (`make_sync_begin`);
    the next round runs its first min(overlap_depth, h) steps on the stale
    params, then applies the pending sync — exactly at depth 0 (bitwise
    the blocking trajectory), as the correction x_i <- x_i + (consensus -
    x_i_at_boundary) at depth > 0.  The boundary params are CLONED before
    those steps: on the card the optimizer updates params in place.
    `synced_view` (pure) gives an observer the consensus, `flush` applies
    the last pending sync.
  * "partial": the boundary mean runs over the lanes of the membership mask
    (`membership_epoch`), and every lane re-anchors to it.
The ring-int8 wire (`RunConfig.sync_wire`) composes with blocking and
overlap on the flat layout.  `membership_epoch` also resizes the worker
axis (lanes leave or join) through the tree layout.

Checkpoints (`save` / `restore`) are the reference's files
(`checkpoint/io.py`): the state, its step and `checkpoint_extra()` (the
H-trace, W and the layout record), so a resumed run lands on the next round
boundary, and `restore` converts a checkpoint written under the other
layout through the tree layout.  `save_sharded` writes the manifest form
(one shard file a rank; a mesh-less engine writes one), and
`restore_elastic` reads a manifest or a monolithic checkpoint written under
any W, layout, shard count or process count: lanes beyond this engine's W
are dropped, missing lanes clone lane 0 (params and moments), the rest stay
bitwise.  A mesh rank checkpoints only through these two (it holds one
chunk), and a worker set that grows or shrinks under a mesh is a new
generation of processes that restores the last manifest
(`launch/multihost.py --mode elastic`).  A mesh rank whose checkpoint has
its own layout, shard count and W reads only the entries that overlap its
blocks; any other goes the reference's way (the whole state assembled and
converted through the tree layout), then the rank keeps its slices.

The adaptive controller's two knobs (`core/controller.py`) move here at
round boundaries: `set_overlap_depth` (read for a pending apply when the
round runs) and, on an engine built with `adaptive_batch=True`,
`batch_epoch(lanes)`: every later step trains on its batch's samples
[0, lanes) tiled over the b_loc slots (`data/synthetic.py
effective_batch_view`), viewed after the draw, on host and device data
alike.  The host still draws all b_loc samples and the step computes all
of them, as the reference's fixed-shape program does.

A lane resize on a live mesh raises (as the reference's does): the
ranks checkpoint with `save_sharded` and respawn, and the new generation
restores through `restore_elastic`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import flat
from repro_torch.core import local_update as LU
from repro_torch.core.sync import (make_sync, make_sync_apply,
                                   make_sync_begin, make_sync_partial)
from repro_torch.data.synthetic import (TokenStream, device_batch_fn,
                                        effective_batch_view,
                                        make_train_batch)
from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError
from repro_torch.models import api, param as pm

Tree = Any


class PendingSyncError(RuntimeError):
    """An overlap-mode sync is still in flight where a synced state is
    required: a checkpoint or readout must never hold pre-consensus params
    (a real exception: asserts vanish under `python -O`)."""


class MembershipError(RuntimeError):
    """An illegal worker-set change: membership may only move at a round
    boundary (never with a sync in flight), and a mask must keep at least
    one participant."""


@dataclasses.dataclass(frozen=True)
class MembershipEpoch:
    """One round-boundary change of the worker set, appended to
    `engine.epochs` by `membership_epoch()`.  (The reference's `parked`
    compile-cache keys have no counterpart: nothing is compiled.)

    index:      epoch ordinal
    workers:    worker-axis size W after the change
    membership: the participation mask in force, one float per lane
    resized:    True when the W axis itself changed
    """
    index: int
    workers: int
    membership: tuple[float, ...]
    resized: bool


@dataclasses.dataclass(frozen=True)
class BatchEpoch:
    """One round-boundary change of the effective per-worker batch,
    appended to `engine.batch_epochs` by `batch_epoch()`.

    index:       epoch ordinal
    lanes:       effective per-worker batch after the change (divides b_loc)
    b_loc:       the allocated per-worker batch (the drawn shape, unchanged)
    round_index: rounds executed when the change landed (the boundary)
    """
    index: int
    lanes: int
    b_loc: int
    round_index: int


def worker_divergence(params: Tree) -> torch.Tensor:
    """mean_i ||x_i - x_bar||_2 over the leading worker axis, all leaves."""
    sq = 0.0
    for x in T.leaves(params):
        xf = x.float()
        m = torch.mean(xf, 0, keepdim=True)
        sq = sq + torch.sum(torch.square(xf - m), dim=tuple(range(1, xf.ndim)))
    return torch.mean(torch.sqrt(sq))


def _remap_worker_lanes(tree_state: Tree, lanes: list[int]) -> Tree:
    """Tree-layout state with its worker axis re-padded to `lanes` (source
    lane per new slot; repeating a lane clones it — params AND moments).
    The anchor, outer momentum and step counter carry no worker axis."""
    take = lambda x: torch.stack([x[i] for i in lanes])    # noqa: E731
    out = dict(tree_state)
    out["params"] = T.map(take, tree_state["params"])
    out["opt"] = {k: (T.map(take, v) if k in flat._STACKED else v)
                  for k, v in tree_state["opt"].items()}
    return out


def _checkpoint_meta(path: str) -> tuple[bool, dict]:
    """(is it a manifest, its extra) of a manifest or monolithic
    checkpoint."""
    manifest = ckpt_io.is_manifest(path)
    _, extra = (ckpt_io.read_manifest_meta(path) if manifest
                else ckpt_io.read_meta(path))
    return manifest, extra


def _metrics(params, losses, gns, denom):
    return {"loss": torch.sum(torch.stack(losses)) / denom,
            "grad_norm": torch.sum(torch.stack(gns)) / denom,
            "divergence": worker_divergence(params)}


class RoundEngine:
    """Owns the run state's layout, the data source and the H-trace.

    device: where the run's state lives — CUDA unless the caller asks for
    the CPU (`repro_torch.device.resolve_device`)."""

    def __init__(self, cfg, run_cfg, *, workers: int, b_loc: int, seq: int,
                 seed: int = 0, mode: str = "bucketed", data: str = "device",
                 layout: str = "tree", sync: str = "blocking",
                 overlap_depth: int = 0, shards: int = 0, mesh=None,
                 policy: str = "dp", batch_fn: Callable | None = None,
                 adaptive_batch: bool = False, device=None):
        if mode not in ("bucketed", "legacy"):
            raise ConfigError(f"unknown engine mode {mode!r}")
        if data not in ("device", "host"):
            raise ConfigError(f"unknown data source {data!r}")
        if layout not in ("tree", "flat", "flat_sharded"):
            raise ConfigError(f"unknown param layout {layout!r}")
        if sync not in ("blocking", "overlap", "partial"):
            raise ConfigError(f"unknown sync mode {sync!r}")
        if overlap_depth < 0:
            raise ConfigError(f"overlap_depth must be >= 0, got {overlap_depth}")
        if batch_fn is not None and data != "host":
            raise ConfigError("batch_fn is a host-data source; pass data='host'")
        if cfg.family == "vision" and not (data == "host" and batch_fn):
            raise ConfigError(
                "vision configs need data='host' and an image batch_fn")
        if sync != "blocking" and mode != "bucketed":
            raise ConfigError(
                "overlap/partial sync runs through the bucketed program")
        if adaptive_batch and mode != "bucketed":
            raise ConfigError(
                "adaptive_batch needs mode='bucketed', as the reference's "
                "engine does")
        if mesh is not None and layout != "flat_sharded":
            raise ConfigError(
                "a mesh drives the explicit-collective sync: layout=flat_sharded")
        self.mesh, self.policy, self.shards = mesh, policy, shards
        self._groups = None
        if mesh is not None:
            got = pm.worker_count(policy, mesh)
            if got != workers:
                raise ConfigError(
                    f"policy {policy!r} on this mesh has {got} workers, "
                    f"engine built with {workers}")
            if device is not None and torch.device(device) != mesh.device:
                raise ConfigError(f"the engine's device {device} is not the "
                                  f"mesh's {mesh.device}")
            device = mesh.device
            # collective: every rank builds its engines in the same order
            self._groups = mesh.groups(pm.worker_mesh_axes(policy, mesh))
        self.device = resolve_device(device)
        self.cfg, self.run_cfg = cfg, run_cfg
        self.workers, self.b_loc, self.seq, self.seed = workers, b_loc, seq, seed
        self.mode, self.data, self.layout = mode, data, layout
        self.sync_mode, self.overlap_depth = sync, overlap_depth
        self.stream = TokenStream(vocab=max(cfg.vocab, 2), seed=seed)
        self._batch_fn = batch_fn           # None: the built-in stream
        self._synth = self._device_synth()  # None: host data
        self.spec = None                    # FlatParamSpace (layout != "tree")
        self._step = self._sync = None
        self._pending = None                # overlap: the in-flight reduce
        # partial sync: the participation mask over the worker axis (all
        # lanes by default); only membership_epoch() changes it
        self.membership = np.ones(workers, np.float32)
        self.epochs: list[MembershipEpoch] = []
        # adaptive effective batch: b_loc samples are drawn a step, the
        # first `batch_lanes` of them tiled over the b_loc slots; only
        # batch_epoch() changes it
        self.adaptive_batch = adaptive_batch
        self.batch_lanes = b_loc
        self.batch_epochs: list[BatchEpoch] = []
        self.h_trace: list[tuple[int, int]] = []    # (t_start, h) executed
        self.round_metrics: list[dict] = []         # per round, device scalars
        self.data_seconds = 0.0                     # host time in batch_fn

    def _device_synth(self):
        """data="device": the on-device synthesizer at the current W (a
        closure over the stream and the shapes, not over the engine)."""
        if self.data != "device":
            return None
        return device_batch_fn(self.cfg, self.stream, self.workers,
                               self.b_loc, self.seq, self.device)

    def _batch(self, step: int) -> Tree:
        """The batch of local step `step` on the engine's device, viewed at
        the effective batch (`batch_lanes`) on an adaptive engine; the host
        time of its draw (a host batch's copy to the device and the view
        left out) goes to `data_seconds`."""
        t0 = time.perf_counter()
        draw = self._synth if self._synth is not None else self._host_batch
        batch = draw(step)
        if self.mesh is not None:
            batch = self._rank_lane(batch)
        self.data_seconds += time.perf_counter() - t0
        batch = T.map(lambda x: x.to(self.device), batch)
        if self.adaptive_batch:
            # the reference views inside its valid-step branch; the port
            # runs no padded step, so every executed step is viewed, before
            # the worker loop and before a microbatch splits it
            batch = effective_batch_view(batch, self.batch_lanes, axis=1)
        return batch

    def _rank_lane(self, batch: Tree) -> Tree:
        """A mesh rank's lane of a batch: lane `worker_index` of a W-lane
        batch (device data, or a reference-style `batch_fn`), a one-lane
        batch as it is (the rank's own, e.g. `lanes=[i]`)."""
        lanes = T.leaves(batch)[0].shape[0]
        if lanes == 1:
            return batch
        if lanes != self.workers:
            raise ConfigError(
                f"a mesh rank takes a batch of {self.workers} lanes (it keeps "
                f"its worker's) or of 1 (its own), got {lanes} lanes")
        i = self._groups.worker_index
        return T.map(lambda x: x[i:i + 1], batch)

    def _host_batch(self, step: int) -> Tree:
        """The batch of local step `step`: `batch_fn`'s, or the built-in
        stream's at the engine's current W.  A method, not a lambda kept on
        the engine: a lambda that reads `self` would keep the engine (and
        through it the run's state) alive in a reference cycle after
        `del`."""
        if self._batch_fn is not None:
            return self._batch_fn(step)
        lanes = (None if self.mesh is None
                 else [self._groups.worker_index])
        return make_train_batch(self.cfg, self.stream, step, self.workers,
                                self.b_loc, self.seq, lanes=lanes)

    # -- state ------------------------------------------------------------

    def _ensure_spec(self, params_single: Tree | None = None):
        """The flat spec, recorded once from the first params seen (or the
        config's abstract params): a ShardedFlatSpace of `shards` chunks
        (default: the workers, or every rank of a mesh) for flat_sharded,
        carrying the mesh and its worker / shard axes on a mesh."""
        if self.spec is None:
            if params_single is None:
                mod = api.get_module(self.cfg)
                params_single = pm.abstract_params(mod.param_defs(self.cfg))
            if self.mesh is not None:
                self.spec = flat.ShardedFlatSpace(
                    params_single, self.shards or self.mesh.size,
                    mesh=self.mesh, worker_axes=self._groups.worker_axes,
                    shard_axes=self._groups.shard_axes)
            elif self.layout == "flat_sharded":
                self.spec = flat.ShardedFlatSpace(params_single,
                                                  self.shards or self.workers)
            else:
                self.spec = flat.FlatParamSpace(params_single)
        return self.spec

    def init_state(self, params_single: Tree | None = None) -> Tree:
        """Runtime state on the engine's device: W replicas of
        `params_single` (moved there), or of weights drawn from a
        `torch.Generator` seeded with `seed` on the device."""
        if params_single is None:
            mod = api.get_module(self.cfg)
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            params_single = pm.init_params(mod.param_defs(self.cfg), gen,
                                           device=self.device)
        else:
            params_single = T.map(lambda x: x.to(self.device), params_single)
        if self.mesh is not None:
            # this worker's lane alone, then this rank's chunks of it
            g = self._groups
            state = flat.to_flat_state(
                self._ensure_spec(params_single),
                LU.init_state(self.cfg, self.run_cfg, params_single, 1))
            return flat.take_slices(state, flat.flat_state_slices(
                self.run_cfg, self.spec, 0, g.shard_index, g.n_shards))
        state = LU.init_state(self.cfg, self.run_cfg, params_single,
                              self.workers)
        if self.layout != "tree":
            state = flat.to_flat_state(self._ensure_spec(params_single), state)
        return state

    def params_single(self, state: Tree) -> Tree:
        """Worker-0 params as the model tree, whatever the layout (views)."""
        if self._pending is not None:
            raise PendingSyncError(
                "in-flight sync: pass flush(state) or synced_view(state), "
                "not the raw run state")
        params = state["params"]
        if self.mesh is not None:
            # worker 0's row of each chunk, then the chunks over the shard
            # group: the whole of worker 0's buckets on every rank
            g, mesh = self._groups, self.mesh
            params = {b: mesh.all_gather(
                mesh.all_gather(x[0], g.worker).view(g.n_workers, -1)[0]
                .contiguous(), g.shard)[None] for b, x in params.items()}
        if self.layout != "tree":
            params = self._ensure_spec().unflatten(params, lead=1)
        return T.map(lambda x: x[0], params)

    # -- execution --------------------------------------------------------

    def _programs(self):
        """(local step, sync) for blocking / partial, (local step, (begin,
        apply)) for overlap — built once, rebuilt after a resize."""
        if self._step is None:
            spec = self._ensure_spec() if self.layout != "tree" else None
            self._step = (LU.make_mesh_local_step(self.cfg, self.run_cfg,
                                                  spec)
                          if self.mesh is not None else
                          LU.make_local_step(self.cfg, self.run_cfg,
                                             with_metrics=True, spec=spec))
            if self.sync_mode == "overlap":
                self._sync = (make_sync_begin(self.run_cfg, spec),
                              make_sync_apply(self.run_cfg, spec))
            elif self.sync_mode == "partial":
                self._sync = make_sync_partial(self.run_cfg, spec)
            else:
                self._sync = make_sync(self.run_cfg, spec=spec)
        return self._step, self._sync

    def run_round(self, state: Tree, t: int, h: int, lr_fn):
        """Execute the communication round starting at step t with period h:
        h local steps on batches `batch_fn(t + i)`, then the sync (overlap:
        the pending sync applied after the first min(depth, h) steps, and
        this round's reduce left pending).  Returns (state, metrics) with
        metrics {"loss", "grad_norm", "divergence"} as 0-d device
        tensors."""
        step, sync = self._programs()
        pending = self._pending if self.sync_mode == "overlap" else None
        # the depth in force now, as set at this boundary (the controller's
        # set_overlap_depth may have moved it since the reduce was begun)
        d = min(self.overlap_depth, h) if pending is not None else 0
        entry = None
        if pending is not None and d > 0:
            # the boundary params, kept apart from the in-place steps
            entry = T.map(torch.clone, state["params"])
        losses, gns = [], []
        for i in range(h):
            if pending is not None and i == d:
                with torch.no_grad():
                    state = sync[1](state, pending, entry)
                pending = None
            batch = self._batch(t + i)
            state, (loss, gn) = step(state, batch, lr_fn(t + i))
            losses.append(loss)
            gns.append(gn)
        with torch.no_grad():
            if pending is not None:         # depth >= h: apply at the end
                state = sync[1](state, pending, entry)
            metrics = (self._mesh_metrics(state["params"], losses, gns,
                                          float(h))
                       if self.mesh is not None else
                       _metrics(state["params"], losses, gns, float(h)))
            if self.sync_mode == "overlap":
                self._pending = sync[0](state)
            elif self.sync_mode == "partial":
                state = sync(state, torch.as_tensor(self.membership,
                                                    device=self.device))
            else:
                state = sync(state)
        self.h_trace.append((t, h))
        self.round_metrics.append(metrics)
        return state, metrics

    def _mesh_metrics(self, params, losses, gns, denom):
        """The round's metrics on a mesh rank, the same on every rank: the
        loss and grad norm (this worker's, per step) summed over the worker
        group, and the divergence mean_i ||x_i - x_bar||_2 from the chunks
        (x_bar by one all-reduce of the params chunk over the worker group,
        each worker's squares summed over its shard group).  Their last bits
        may differ from the single-process engine's (another sum order)."""
        g, mesh = self._groups, self.mesh
        w = float(g.n_workers)
        sq = 0.0
        for x in T.leaves(params):
            xf = x[0].float()
            mean = mesh.all_reduce(xf, "sum", g.worker) / w
            sq = sq + torch.sum(torch.square(xf - mean))
        sq = mesh.all_reduce(torch.stack([sq]), "sum", g.shard)
        tot = mesh.all_reduce(torch.stack([
            torch.sum(torch.stack(losses)), torch.sum(torch.stack(gns)),
            torch.sqrt(sq[0])]), "sum", g.worker)
        return {"loss": tot[0] / w / denom, "grad_norm": tot[1] / w / denom,
                "divergence": tot[2] / w}

    def synced_view(self, state: Tree) -> Tree:
        """State with the in-flight sync applied, WITHOUT consuming it: the
        consensus an observer (eval, logging) should see under overlap
        mode.  Pure: the apply writes new tensors, so the training state,
        its anchor and its outer momentum are left as they are."""
        if self._pending is None:
            return state
        with torch.no_grad():
            return self._programs()[1][1](state, self._pending)

    def flush(self, state: Tree) -> Tree:
        """Apply the in-flight sync, if any (overlap mode), leaving the state
        at the consensus a blocking round would have.  Call before reading
        out final params."""
        state = self.synced_view(state)
        self._pending = None
        return state

    def batch_epoch(self, lanes: int) -> None:
        """The only place the effective per-worker batch changes: a round
        boundary, as membership_epoch.  From the next round on each step
        trains on `lanes` samples a worker, tiled over the b_loc drawn
        (`effective_batch_view`); `lanes` must divide b_loc for the tiled
        mean to be an exact batch-`lanes` gradient.  Recorded as a
        BatchEpoch."""
        if not self.adaptive_batch:
            raise MembershipError(
                "batch_epoch needs an adaptive_batch=True engine")
        lanes = int(lanes)
        if not 1 <= lanes <= self.b_loc or self.b_loc % lanes:
            raise MembershipError(
                f"batch lanes must divide b_loc={self.b_loc} "
                f"(got {lanes})")
        self.batch_lanes = lanes
        self.batch_epochs.append(BatchEpoch(
            index=len(self.batch_epochs), lanes=lanes, b_loc=self.b_loc,
            round_index=len(self.h_trace)))

    def set_overlap_depth(self, depth: int) -> None:
        """Retune the overlap depth at a round boundary (overlap engines
        only)."""
        if self.sync_mode != "overlap":
            raise MembershipError(
                "overlap depth is only a knob under sync='overlap'")
        depth = int(depth)
        if depth < 0:
            raise MembershipError(f"overlap depth must be >= 0, got {depth}")
        self.overlap_depth = depth

    # -- elastic membership -----------------------------------------------

    def membership_epoch(self, membership: Sequence[float] | None = None, *,
                         state: Tree | None = None,
                         keep_lanes: Sequence[int] | None = None,
                         grow_to: int | None = None) -> Tree | None:
        """The only place the worker set changes — a round boundary.

        * `membership_epoch([1, 1, 0, 1])` — the participation mask for the
          next rounds (sync="partial"): lane 2 keeps training, but its delta
          is left out of the boundary mean, which divides by |P| = 3.
        * `membership_epoch(state=st, keep_lanes=(0, 1, 3))` — lanes leave:
          the worker axis shrinks to the kept lanes.  Returns the new state.
        * `membership_epoch(state=st, grow_to=4)` — lanes join as clones of
          lane 0 (the post-sync consensus), params and moments.

        Each change is recorded as a MembershipEpoch.  Raises
        MembershipError with a sync in flight or on an empty mask."""
        if self._pending is not None:
            raise MembershipError(
                "membership may only change at a round boundary: a sync is "
                "in flight over the old worker set — flush() first")
        resize = keep_lanes is not None or grow_to is not None
        if resize and self.mesh is not None:
            raise MembershipError(
                "a lane resize under a live mesh: torch.distributed process "
                "groups cannot shrink in place; checkpoint with save_sharded "
                "and respawn the ranks, which restore through "
                "restore_elastic (launch/multihost.py --mode elastic)")
        if resize:
            if state is None:
                raise MembershipError("a resize needs the run state")
            if keep_lanes is not None:
                lanes = [int(i) for i in keep_lanes]
                if not lanes or not all(0 <= i < self.workers
                                        for i in lanes):
                    raise MembershipError(
                        f"keep_lanes {lanes} out of range for "
                        f"W={self.workers}")
            else:
                if grow_to <= self.workers:
                    raise MembershipError(
                        f"grow_to={grow_to} does not grow W={self.workers}")
                lanes = list(range(self.workers)) + \
                    [0] * (grow_to - self.workers)
            state = self._resize_lanes(state, lanes)
            self.membership = np.ones(self.workers, np.float32)
        elif membership is not None:
            mask = np.asarray(membership, np.float32)
            if mask.shape != (self.workers,) or mask.sum() < 1:
                raise MembershipError(
                    f"membership mask must be [{self.workers}] with at "
                    f"least one participant, got {mask!r}")
            self.membership = mask
        self.epochs.append(MembershipEpoch(
            index=len(self.epochs), workers=self.workers,
            membership=tuple(float(x) for x in self.membership),
            resized=resize))
        return state

    def _resize_lanes(self, state: Tree, lanes: list[int]) -> Tree:
        """Re-pad the worker axis to `lanes` through the tree layout, so the
        kept lanes stay bitwise; the flat spec and the step and sync
        callables are rebuilt for the new W."""
        spec = self._ensure_spec() if self.layout != "tree" else None
        tree_state = state if spec is None else flat.to_tree_state(spec,
                                                                   state)
        tree_state = _remap_worker_lanes(tree_state, lanes)
        self.workers = len(lanes)
        self.spec = None
        self._step = self._sync = None
        self._synth = self._device_synth()
        if self.layout == "tree":
            return tree_state
        params_single = T.map(lambda x: x[0], tree_state["params"])
        return flat.to_flat_state(self._ensure_spec(params_single),
                                  tree_state)

    # -- checkpointing ----------------------------------------------------

    def checkpoint_extra(self) -> dict:
        """The engine's checkpoint metadata: the H-trace (resume lands on a
        round boundary), W and the param-layout record for cross-layout
        restore.  The async observer captures it on the round loop's
        thread at snapshot time: the trace keeps advancing while the
        background writer runs."""
        spec = self._ensure_spec() if self.layout != "tree" else None
        return {"h_trace": [[t, h] for t, h in self.h_trace],
                "workers": self.workers,
                **ckpt_io.layout_meta(self.layout, spec)}

    def save(self, path: str, state: Tree, *, step: int,
             flush_pending: bool = False) -> None:
        """Checkpoint the state with the engine's step and H-trace.  The
        flat layout writes its buffers directly, one entry per dtype
        bucket, with the layout recorded for cross-layout restore.

        With an overlap sync in flight this raises PendingSyncError unless
        `flush_pending=True`, which writes the synced view of `state` (the
        consensus a blocking round would have produced) without consuming
        the pending sync; `flush()` + save is the forced sync point."""
        self._no_mesh_checkpoint()
        if self._pending is not None:
            if not flush_pending:
                raise PendingSyncError(
                    "overlap sync in flight: save(flush_pending=True) "
                    "writes the synced consensus without disturbing the "
                    "pipeline, or flush() first for a forced sync point")
            state = self.synced_view(state)
        ckpt_io.save(path, state, step=step, extra=self.checkpoint_extra())

    def restore(self, path: str, like_state: Tree) -> tuple[Tree, int]:
        """Restore into this engine's layout, on `like_state`'s devices.
        A checkpoint written under the other layout (tree <-> flat) is
        converted on the way in through the tree layout; flatten and
        unflatten are exact, so the resumed run stays bitwise.  Adopts the
        checkpoint's H-trace and returns (state, step).

        Refuses a live in-flight sync (it would orphan a round's reduce):
        flush() first."""
        self._no_mesh_checkpoint()
        if self._pending is not None:
            raise PendingSyncError(
                "restore() with an overlap sync in flight would orphan the "
                "pending reduce: flush() the current state first")
        _, meta = ckpt_io.read_meta(path)
        ck_layout = meta.get("layout", "tree")
        ck_shards = meta.get("shards")
        if ck_layout not in ("tree", "flat", "flat_sharded"):
            raise ConfigError(f"restoring a {ck_layout!r} checkpoint: not "
                              "ported yet")
        my_shards = (getattr(self._ensure_spec(), "shards", None)
                     if self.layout != "tree" else None)
        convert = ck_layout != self.layout or ck_shards != my_shards
        ck_spec = None
        if convert:
            tree_state = (like_state if self.layout == "tree"
                          else flat.to_tree_state(self._ensure_spec(),
                                                  like_state))
            if ck_layout == "tree":
                like = tree_state
            else:
                single = T.map(lambda x: x[0], tree_state["params"])
                ck_spec = (flat.ShardedFlatSpace(single, ck_shards or 1)
                           if ck_layout == "flat_sharded"
                           else flat.FlatParamSpace(single))
                like = flat.to_flat_state(ck_spec, tree_state)
        else:
            like = like_state
        state, step, extra = ckpt_io.restore_with_meta(path, like)
        if convert:
            if ck_spec is not None:
                state = flat.to_tree_state(ck_spec, state)
            if self.layout != "tree":
                state = flat.to_flat_state(self._ensure_spec(), state)
        return state, self._adopt_trace(extra, step)

    def _no_mesh_checkpoint(self) -> None:
        if self.mesh is not None:
            raise ConfigError(
                "a mesh rank holds one chunk of the state: checkpoint it with "
                "save_sharded and restore it with restore_elastic")

    def _adopt_trace(self, extra: dict, step) -> int:
        trace = [(int(t), int(h)) for t, h in extra.get("h_trace", [])]
        step = int(step or 0)
        if trace:
            done = trace[-1][0] + trace[-1][1]
            if done != step:
                raise ValueError(
                    f"checkpoint step {step} is not the round boundary "
                    f"implied by its H-trace (ends at {done})")
        self.h_trace = trace
        return step

    # -- sharded checkpoints and elastic restore ------------------------------

    def save_sharded(self, path: str, state: Tree, *, step: int,
                     flush_pending: bool = False) -> None:
        """The manifest checkpoint (`checkpoint/io.py save_sharded`): a mesh
        rank writes the blocks of the global state it owns (every rank's
        blocks are derived from the mesh coordinates; a replica, such as the
        anchor across the workers or the step, is the lowest rank's), and
        rank 0 the manifest, after the mesh's barrier; the barrier runs
        again after the manifest, so when this returns on any rank the
        checkpoint is whole.  A mesh-less engine is one process and writes
        one file.  Same PendingSyncError contract as `save`."""
        if self._pending is not None:
            if not flush_pending:
                raise PendingSyncError(
                    "overlap sync in flight: save_sharded(flush_pending="
                    "True) writes the synced consensus without disturbing "
                    "the pipeline, or flush() first")
            state = self.synced_view(state)
        if self.mesh is None:
            ckpt_io.save_sharded(path, state, step=step,
                                 extra=self.checkpoint_extra())
            return
        ckpt_io.save_sharded(path, state, step=step,
                             extra=self.checkpoint_extra(),
                             barrier=self.mesh.barrier,
                             placement=self._placement(state),
                             rank=self.mesh.rank)
        self.mesh.barrier()

    def _rank_slices(self, worker: int, shard: int) -> Tree:
        g = self._groups
        return flat.flat_state_slices(self.run_cfg, self._ensure_spec(),
                                      worker, shard, g.n_shards)

    def _placement(self, state: Tree) -> Tree:
        """A mesh rank's state as `checkpoint/io.py` Placements: every
        leaf's global shape and each rank's block of it, from each rank's
        (worker, shard) position and `flat_state_slices`."""
        per_rank = [self._rank_slices(w, s)
                    for w, s in self.mesh.positions(self._groups.worker_axes)]

        def place(x, *slices):
            if not isinstance(x, torch.Tensor):
                return None
            blocks = tuple(tuple((sl.start, sl.stop) for sl in sls)
                           for sls in slices)
            shape = tuple(max(b[d][1] for b in blocks)
                          for d in range(x.ndim))
            return ckpt_io.Placement(shape, blocks)

        return T.map(place, state, *per_rank)

    def restore_elastic(self, path: str, like_state: Tree) -> tuple[Tree, int]:
        """Restore a checkpoint written under any worker count, layout,
        shard count or process count, manifest or monolithic, into this
        engine -> (state, step), the H-trace adopted.  Lanes beyond this
        engine's W are dropped (highest first); missing lanes clone the
        checkpoint's lane 0, params and moments both: at a round boundary
        every participating lane holds the consensus, so the clone is the
        re-anchoring a rejoining worker needs (zero moments would de-bias
        Adam against the shared step counter).  The kept lanes stay
        bitwise.  `like_state` (this engine's state, or its shapes) gives
        each leaf its device.

        A mesh rank reading a manifest of its own layout, shard count and W
        reads only its blocks (module docstring); any other checkpoint is
        assembled whole on the host, converted on the rank's device, and
        sliced to the rank's chunks.  The participation mask resets to every lane."""
        if self._pending is not None:
            raise PendingSyncError(
                "restore_elastic() with an overlap sync in flight would "
                "orphan the pending reduce: flush() first")
        manifest, extra = _checkpoint_meta(path)
        ck_w = int(extra.get("workers") or self.workers)
        if (self.mesh is not None and manifest
                and extra.get("layout") == "flat_sharded"
                and extra.get("shards") == self._ensure_spec().shards
                and ck_w == self.workers):
            g = self._groups
            slices = self._rank_slices(g.worker_index, g.shard_index)
            blocks = T.map(lambda sl: tuple((s.start, s.stop) for s in sl),
                           slices)
            state, step, extra = ckpt_io.restore_sharded(path, like_state,
                                                         blocks=blocks)
        else:
            state, step, extra = self._restore_whole(path, like_state,
                                                     manifest, extra)
        self.membership = np.ones(self.workers, np.float32)
        return state, self._adopt_trace(extra, step)

    def _restore_whole(self, path: str, like_state: Tree, manifest: bool,
                       extra: dict):
        """The reference's route: the checkpoint's whole state read on the
        host into a template of the writer's geometry (lanes, layout,
        shards), then on the engine's device converted to the tree layout,
        its lanes remapped to this engine's W, and laid out in this engine's
        layout (on a mesh rank, then sliced to the rank's chunks); each leaf
        then moved to its `like_state` leaf's device.  `manifest`, `extra`:
        the checkpoint's `_checkpoint_meta`.  -> (state, step, extra)."""
        ck_layout = extra.get("layout", "tree")
        if ck_layout not in ("tree", "flat", "flat_sharded"):
            raise ConfigError(f"restoring a {ck_layout!r} checkpoint: not "
                              "ported yet")
        ck_shards = extra.get("shards")
        ck_w = int(extra.get("workers") or self.workers)
        spec = self._ensure_spec() if self.layout != "tree" else None
        # shapes only: templates on the meta device, restored to the CPU
        meta = T.map(lambda x: (torch.empty(x.shape, dtype=x.dtype,
                                            device="meta")
                                if isinstance(x, torch.Tensor) else x),
                     like_state)
        if self.mesh is not None:
            meta = self._whole_template(meta)
        my_tree = meta if spec is None else flat.to_tree_state(spec, meta)
        to_ck = (list(range(ck_w)) if ck_w <= self.workers
                 else list(range(self.workers)) + [0] * (ck_w - self.workers))
        ck_tree = _remap_worker_lanes(my_tree, to_ck)
        ck_spec = None
        if ck_layout != "tree":
            single = T.map(lambda x: x[0], ck_tree["params"])
            ck_spec = (flat.ShardedFlatSpace(single, ck_shards or 1)
                       if ck_layout == "flat_sharded"
                       else flat.FlatParamSpace(single))
        like = (ck_tree if ck_spec is None
                else flat.to_flat_state(ck_spec, ck_tree))
        read = (ckpt_io.restore_sharded if manifest
                else ckpt_io.restore_with_meta)
        state, step, extra = read(path, like)
        # the conversions below copy the state twice: on the engine's
        # device, not in host memory (copies: the same bits anywhere)
        state = T.map(lambda x: (x.to(self.device)
                                 if isinstance(x, torch.Tensor) else x),
                      state)
        if ck_spec is not None:
            state = flat.to_tree_state(ck_spec, state)
        back = (list(range(self.workers)) if ck_w >= self.workers
                else list(range(ck_w)) + [0] * (self.workers - ck_w))
        state = _remap_worker_lanes(state, back)
        if spec is not None:
            state = flat.to_flat_state(spec, state)
        if self.mesh is not None:
            g = self._groups
            state = flat.take_slices(state, self._rank_slices(
                g.worker_index, g.shard_index))
        state = T.map(lambda got, want: (got.to(want.device)
                                         if isinstance(want, torch.Tensor)
                                         else got), state, like_state)
        return state, step, extra

    def _whole_template(self, rank_meta: Tree) -> Tree:
        """The whole flat state's shapes (W lanes, every chunk) from a mesh
        rank's state template."""
        spec = self._ensure_spec()

        def whole(bufs, lead):
            return {b: torch.empty(lead + (spec.buffer_size(b),),
                                   dtype=x.dtype, device="meta")
                    for b, x in bufs.items()}

        out = {k: whole(v, ()) for k, v in rank_meta.items()
               if k in ("anchor", "outer_mu")}
        out["params"] = whole(rank_meta["params"], (self.workers,))
        out["opt"] = {k: (whole(v, (self.workers,)) if k in flat._STACKED
                          else v) for k, v in rank_meta["opt"].items()}
        return out
