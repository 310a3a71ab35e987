"""A mesh of ranks over `torch.distributed` (the port's counterpart of
`repro/launch/mesh.py`, which builds `jax.make_mesh` meshes of TPU chips).

One process is one rank, and rank r sits at the row-major coordinates of
`dims`, as `jax.make_mesh` orders devices.  For a set of worker axes (a
sharding policy's, `models/param.py`) `Mesh.groups` builds three groups
with `dist.new_group`: the world, the worker group (the ranks that differ
from this one only on the worker axes) and the shard group (only on the
other axes).  Within a group, group-rank order is the row-major order of
the group's own axes, so the worker group lists workers 0..W-1 and the
shard group chunks 0..S-1.

The collective verbs the sync and the mesh engine need, and nothing else:
`reduce_scatter_sum`, `all_gather`, `all_reduce` (MAX and SUM) and
`ring_shift` (one hop to the next rank of a group's ring, by
`batch_isend_irecv`).  Each takes and returns 1-D tensors on the mesh's
device.  `barrier` waits for every rank of the world (a sharded
checkpoint's shard files are durable before rank 0 names them).

Staging is fixed by the backend: gloo takes CPU tensors, so a device
payload is copied to a pinned host buffer, sent, and copied back (the time
of those copies is `stats.staging_s`); NCCL takes device tensors as they
are.  Every verb counts its calls and the bytes this rank sends in a ring
implementation of it (`stats`): (g - 1) / g of the input for a
reduce-scatter over g ranks, (g - 1) pieces for an all-gather, 2 (g - 1) /
g for an all-reduce, the payload for a shift.

The int16 rule: neither gloo nor NCCL has an int16 type, and the exact
code sums of the quantized sync travel as int16 whenever W * 127 < 2^15
(`core/sync.py wire_dtype`).  An int16 reduce-scatter here is a ring of
g - 1 `ring_shift` hops whose payload moves as an int8 view of the same
bytes and is added in int16 on the receiving side; an int16 all-gather
moves the codes as an int8 view.  Integer sums are exact in any order, so
the result is the library reduce-scatter's, at the reference's wire bytes.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass
class Group:
    """One process group of the mesh: its handle, its members' global ranks
    in group order, and this rank's index among them.  A one-rank group
    split off a larger world has no handle, and its verbs copy."""
    handle: object
    ranks: tuple[int, ...]
    index: int
    trivial: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass
class MeshGroups:
    """The groups of one split of the mesh into worker and shard axes."""
    world: Group
    worker: Group
    shard: Group
    worker_axes: tuple[str, ...]
    shard_axes: tuple[str, ...]

    @property
    def n_workers(self) -> int:
        return self.worker.size

    @property
    def n_shards(self) -> int:
        return self.shard.size

    @property
    def worker_index(self) -> int:
        return self.worker.index

    @property
    def shard_index(self) -> int:
        return self.shard.index


@dataclasses.dataclass
class Stats:
    """Calls and wire bytes by verb, and the host-staging seconds."""
    calls: dict = dataclasses.field(default_factory=dict)
    wire_bytes: dict = dataclasses.field(default_factory=dict)
    staging_s: float = 0.0

    def add(self, verb: str, nbytes: float) -> None:
        self.calls[verb] = self.calls.get(verb, 0) + 1
        self.wire_bytes[verb] = self.wire_bytes.get(verb, 0) + int(nbytes)

    def reset(self) -> None:
        self.calls, self.wire_bytes, self.staging_s = {}, {}, 0.0


def _coords(rank: int, dims: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return tuple(reversed(out))


def _linear(coords, dims) -> int:
    idx = 0
    for c, d in zip(coords, dims):
        idx = idx * d + c
    return idx


class Mesh:
    """`dims` ranks over `axis_names`, one process each, on an initialized
    default process group whose world size is prod(dims).

    backend: "gloo" or "nccl" (default: the default group's); device: where
    the rank's tensors live: a card unless the caller asks for the CPU
    (`repro_torch.device.resolve_device`; nccl takes cards only).  A gloo
    mesh of CUDA tensors stages every payload through pinned host memory."""

    def __init__(self, dims, axis_names, *, backend: str | None = None,
                 device=None):
        self.dims = tuple(int(d) for d in dims)
        self.axis_names = tuple(axis_names)
        if len(self.dims) != len(self.axis_names):
            raise ConfigError(f"mesh dims {self.dims} and axes "
                              f"{self.axis_names} differ in rank")
        if not dist.is_initialized():
            raise ConfigError("the mesh needs torch.distributed initialized "
                              "(launch/multihost.py initialize)")
        if dist.get_world_size() != math.prod(self.dims):
            raise ConfigError(
                f"mesh {'x'.join(map(str, self.dims))} needs "
                f"{math.prod(self.dims)} processes, the world has "
                f"{dist.get_world_size()}")
        self.backend = backend or dist.get_backend()
        if self.backend not in ("gloo", "nccl"):
            raise ConfigError(f"unknown backend {self.backend!r}")
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ConfigError("nccl carries CUDA tensors: pass a cuda device")
        self.rank = dist.get_rank()
        self.coords = _coords(self.rank, self.dims)
        self.shape = dict(zip(self.axis_names, self.dims))
        self.stats = Stats()
        self._groups: dict[tuple[str, ...], MeshGroups] = {}
        self._staging: dict = {}

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def groups(self, worker_axes) -> MeshGroups:
        """The world, worker and shard groups for `worker_axes` (the other
        axes are the shard axes).  Every rank must call this with the same
        axes in the same order: `dist.new_group` is collective."""
        waxes = tuple(a for a in self.axis_names if a in tuple(worker_axes))
        if waxes in self._groups:
            return self._groups[waxes]
        saxes = tuple(a for a in self.axis_names if a not in waxes)
        world = Group(None, tuple(range(self.size)), self.rank)
        worker = self._split(waxes)
        shard = self._split(saxes)
        out = MeshGroups(world, worker, shard, waxes, saxes)
        self._groups[waxes] = out
        return out

    def positions(self, worker_axes) -> list[tuple[int, int]]:
        """(worker index, shard index) of every rank, by rank: the indices
        `groups(worker_axes)` gives that rank, computed from the mesh
        coordinates alone (no communication)."""
        waxes = [i for i, a in enumerate(self.axis_names)
                 if a in tuple(worker_axes)]
        saxes = [i for i in range(len(self.dims)) if i not in waxes]
        out = []
        for r in range(self.size):
            c = _coords(r, self.dims)
            out.append(tuple(_linear([c[i] for i in ax],
                                     [self.dims[i] for i in ax])
                             for ax in (waxes, saxes)))
        return out

    def _split(self, axes) -> Group:
        """New groups of the ranks that differ only on `axes` (one per fixed
        value of the other axes, all made on every rank); returns this
        rank's."""
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.dims)) if i not in pos]
        mine = None
        for fixed in _product([self.dims[i] for i in rest]):
            members = []
            for var in _product([self.dims[i] for i in pos]):
                c = [0] * len(self.dims)
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(pos, var):
                    c[i] = v
                members.append(_linear(c, self.dims))
            handle = (dist.new_group(members, backend=self.backend)
                      if len(members) > 1 else None)
            if self.rank in members:
                mine = Group(handle, tuple(members), members.index(self.rank),
                             trivial=handle is None)
        return mine

    # -- staging ----------------------------------------------------------

    def _host(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _to_wire(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """The tensor the backend takes: `x` itself, or (gloo on the card) a
        pinned host copy kept per (tag, shape, dtype) between calls."""
        if not self._host():
            return x.contiguous()
        t0 = time.perf_counter()
        buf = self._buffer(tag, x.shape, x.dtype)
        buf.copy_(x)
        self.stats.staging_s += time.perf_counter() - t0
        return buf

    def _buffer(self, tag, shape, dtype) -> torch.Tensor:
        key = (tag, tuple(shape), dtype)
        buf = self._staging.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, device="cpu",
                              pin_memory=torch.cuda.is_available())
            self._staging[key] = buf
        return buf

    def _out(self, shape, dtype, tag: str) -> torch.Tensor:
        if self._host():
            return self._buffer(tag, shape, dtype)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _from_wire(self, y: torch.Tensor) -> torch.Tensor:
        if not self._host():
            return y
        t0 = time.perf_counter()
        out = y.to(self.device)
        self.stats.staging_s += time.perf_counter() - t0
        return out

    # -- verbs ------------------------------------------------------------

    def reduce_scatter_sum(self, x: torch.Tensor, group: Group) -> torch.Tensor:
        """x [n] (n a multiple of the group size g) -> this rank's [n / g]:
        the sum over the group of each rank's x, chunk `group.index`.
        int16 travels as a ring of int8 views (module docstring)."""
        _check_1d(x, group.size)
        g = group.size
        if group.trivial:
            return x.clone()
        if x.dtype == torch.int16:
            return self._ring_reduce_scatter(x, group)
        self.stats.add("reduce_scatter", x.numel() * x.element_size()
                       * (g - 1) / g)
        src = self._to_wire(x, "rs_in")
        out = self._out((x.numel() // g,), x.dtype, "rs_out")
        _reduce_scatter(out, src, group.handle)
        return self._from_wire(out)

    def _ring_reduce_scatter(self, x: torch.Tensor, group: Group):
        """g - 1 hops: the partial sum of chunk c starts at rank c + 1 and
        each rank it reaches adds its own chunk c, in int16."""
        g, i = group.size, group.index
        self.stats.add("reduce_scatter", x.numel() * x.element_size()
                       * (g - 1) / g)
        chunks = x.view(g, -1)
        acc = chunks[(i - 1) % g].clone()
        for k in range(1, g):
            acc = self._shift(acc.view(torch.int8), group).view(torch.int16)
            acc += chunks[(i - 1 - k) % g]
        return acc

    def all_gather(self, x: torch.Tensor, group: Group) -> torch.Tensor:
        """x [n] -> [g n]: every rank's x in group order.  int16 travels
        as an int8 view of its bytes."""
        _check_1d(x, 1)
        g = group.size
        if group.trivial:
            return x.clone()
        if x.dtype == torch.int16:
            return self.all_gather(x.contiguous().view(torch.int8),
                                   group).view(torch.int16)
        self.stats.add("all_gather", x.numel() * x.element_size() * (g - 1))
        src = self._to_wire(x, "ag_in")
        out = self._out((g * x.numel(),), x.dtype, "ag_out")
        _all_gather(out, src, group.handle)
        return self._from_wire(out)

    def all_reduce(self, x: torch.Tensor, op: str, group: Group) -> torch.Tensor:
        """x [n] -> the group's elementwise `op` ("sum" or "max") of x, as a
        new tensor."""
        _check_1d(x, 1)
        g = group.size
        if group.trivial:
            return x.clone()
        self.stats.add("all_reduce", x.numel() * x.element_size()
                       * 2 * (g - 1) / g)
        if self._host():
            buf = self._to_wire(x, "ar")
        else:
            buf = x.clone()
        dist.all_reduce(buf, op=_OPS[op], group=group.handle)
        return self._from_wire(buf)

    def barrier(self) -> None:
        """Return once every rank of the mesh has called this (the world
        group, the reference's `sync_global_devices`).  Counted in
        `stats.calls`; it sends no payload."""
        self.stats.add("barrier", 0)
        if self.size == 1:
            return
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def ring_shift(self, x: torch.Tensor, group: Group) -> torch.Tensor:
        """Send x [n] to the next rank of the group's ring and return the
        previous rank's (the reference's `ppermute` with perm j -> j + 1).
        int16 travels as an int8 view of its bytes."""
        _check_1d(x, 1)
        g = group.size
        if g == 1:
            return x.clone()
        self.stats.add("ring_shift", x.numel() * x.element_size())
        if x.dtype == torch.int16:
            return self._shift(x.contiguous().view(torch.int8),
                               group).view(torch.int16)
        return self._shift(x, group)

    def _shift(self, x: torch.Tensor, group: Group) -> torch.Tensor:
        g = group.size
        nxt = group.ranks[(group.index + 1) % g]
        prv = group.ranks[(group.index - 1) % g]
        src = self._to_wire(x, "shift_in")
        out = self._out(x.shape, x.dtype, "shift_out")
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, nxt, group.handle),
            dist.P2POp(dist.irecv, out, prv, group.handle)])
        for r in reqs:
            r.wait()
        return self._from_wire(out)


def _check_1d(x: torch.Tensor, g: int) -> None:
    if x.ndim != 1 or x.numel() % g:
        raise ConfigError(f"a collective takes 1-D tensors whose length the "
                          f"group size {g} divides, got {tuple(x.shape)}")


def _reduce_scatter(out, src, handle) -> None:
    fn = getattr(dist, "reduce_scatter_single", None)
    if fn is None:
        fn = dist.reduce_scatter_tensor
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, src, group=handle)


def _all_gather(out, src, handle) -> None:
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, src, group=handle)


def _product(sizes):
    """Row-major tuples over `sizes` (itertools.product of ranges)."""
    if not sizes:
        yield ()
        return
    for head in range(sizes[0]):
        for tail in _product(sizes[1:]):
            yield (head,) + tail


def make_debug_mesh(n_data: int = 4, n_model: int = 2, *, pods: int = 0,
                    backend: str | None = None, device=None) -> Mesh:
    """A mesh with the reference's axis names: (data, model), or (pod, data,
    model) with `pods`."""
    if pods:
        return Mesh((pods, n_data, n_model), ("pod", "data", "model"),
                    backend=backend, device=device)
    return Mesh((n_data, n_model), ("data", "model"), backend=backend,
                device=device)
