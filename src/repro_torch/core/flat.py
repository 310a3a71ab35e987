"""FlatParamSpace: a parameter tree viewed as a few dtype-bucketed 1-D
buffers (port of `repro/core/flat.py` FlatParamSpace).

Leaves are taken in the reference's `jax.tree.flatten` order — dict keys
sorted at every level (`repro_torch.tree`) — and grouped into one contiguous
1-D buffer per leaf dtype, so a bucket built here holds the same elements at
the same offsets as the JAX package's (tested bitwise).  A serving process
keeps its weights as these buckets: a hot swap is one contiguous copy per
dtype.

Memory: `unflatten` returns VIEWS into the buckets, never copies, so the
model reads the buckets' storage directly and `ServingWeights.from_seed`
initializes the weights by writing through those views — one copy of the
weights at peak, which is what lets gemma3-4b's 15.5 GB of fp32 weights
serve from one card.  `flatten` concatenates, so it allocates the buckets.

Training adds the per-tensor segment reductions (`segment_ids`,
`segment_max`, `spread`, which the quantized sync's per-tensor scales use)
and the runtime-state conversions `to_flat_state` / `to_tree_state`.

`ShardedFlatSpace` (`--param-layout flat_sharded`) pads each bucket with
zeros to a multiple of `shards`, so that it splits into contiguous chunks:
a rank of a mesh (`launch/mesh.py`) keeps its worker's chunk of params and
moments and its chunk of the anchor (`flat_state_slices`, the reference's
`flat_state_specs` written as slices), and the sync's worker mean splits
into a reduce-scatter and an all-gather per bucket (`core/sync.py`).
Without a mesh the padded buffers run the flat path, bitwise the flat
layout: pad elements start at zero and stay there, and the pad's segment
id (#leaves) is dropped by `segment_max`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.errors import LayoutError

Tree = Any


def dtype_name(dtype: torch.dtype) -> str:
    """Bucket name of a dtype, as the reference names it ("float32")."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One tree leaf's placement inside its dtype bucket."""
    bucket: str
    index: int           # segment id within the bucket (bucket-local order)
    offset: int          # element offset within the bucket buffer
    size: int
    shape: tuple[int, ...]


class FlatParamSpace:
    """Bidirectional view between a parameter tree and dtype-bucketed
    buffers.  Built once from a tree of tensors (`meta` tensors are enough);
    `lead` counts leading batch-like axes shared by every leaf: leaves
    `[*lead, *shape]` map to buffers `[*lead, N_bucket]`."""

    def __init__(self, tree: Tree):
        leaves, self.treedef = T.flatten(tree)
        if not leaves:
            raise LayoutError("empty params tree")
        self._leaves: list[_Leaf] = []
        self.dtypes: dict[str, torch.dtype] = {}
        sizes: dict[str, int] = {}
        order: dict[str, list[int]] = {}
        for i, x in enumerate(leaves):
            b = dtype_name(x.dtype)
            self.dtypes[b] = x.dtype
            off = sizes.get(b, 0)
            n = math.prod(x.shape)
            self._leaves.append(_Leaf(b, len(order.setdefault(b, [])), off, n,
                                      tuple(x.shape)))
            order[b].append(i)
            sizes[b] = off + n
        self.buckets: tuple[str, ...] = tuple(sorted(sizes))
        self.sizes: dict[str, int] = {b: sizes[b] for b in self.buckets}
        self._order = order           # bucket -> leaf indices, offset order

    def bucket_leaves(self, bucket: str) -> int:
        return len(self._order[bucket])

    def buffer_size(self, bucket: str) -> int:
        """Bucket-buffer length as `flatten` makes it (the sharded subclass
        pads it to a multiple of its chunk count)."""
        return self.sizes[bucket]

    def segment_ids(self, bucket: str) -> np.ndarray:
        """int32 [N_bucket]: which leaf (bucket-local index) each element of
        the bucket buffer belongs to — the per-tensor reduction map."""
        seg = np.empty(self.sizes[bucket], np.int32)
        for i in self._order[bucket]:
            lf = self._leaves[i]
            seg[lf.offset:lf.offset + lf.size] = lf.index
        return seg

    def segment_max(self, bucket: str, x: torch.Tensor) -> torch.Tensor:
        """Per-leaf max of an `[N]` bucket-shaped tensor -> `[#leaves]`, in
        bucket-local leaf order.  max is exact, so this equals a per-tensor
        `torch.max` bitwise."""
        return self.chunk_segment_max(bucket, x, 0)

    def chunk_segment_max(self, bucket: str, x: torch.Tensor,
                          lo: int) -> torch.Tensor:
        """Per-leaf max of the elements [lo, lo + len(x)) of a bucket-shaped
        tensor, given as `x` -> `[#leaves]`; a leaf with no element there
        reports -inf (the max identity), and pad elements belong to no leaf.
        A max over every chunk's partials is the whole leaf's max, exactly
        (the reference's `partial_segment_amax`)."""
        hi = lo + x.shape[0]
        out = []
        for i in self._order[bucket]:
            lf = self._leaves[i]
            a, b = max(lf.offset, lo), min(lf.offset + lf.size, hi)
            out.append(x.narrow(0, a - lo, b - a).max() if a < b
                       else x.new_full((), float("-inf")))
        return torch.stack(out)

    def spread(self, bucket: str, per_leaf: torch.Tensor) -> torch.Tensor:
        """Per-tensor values `[#leaves]` -> elements `[N]` (each leaf's
        value repeated over its elements; pad elements take the last
        leaf's, as the reference's clamped gather does)."""
        return self.chunk_spread(bucket, per_leaf, 0, self.buffer_size(bucket))

    def chunk_spread(self, bucket: str, per_leaf: torch.Tensor, lo: int,
                     hi: int) -> torch.Tensor:
        """The elements [lo, hi) of `spread(bucket, per_leaf)`."""
        sizes, last = [], self._order[bucket][-1]
        for i in self._order[bucket]:
            lf = self._leaves[i]
            end = self.buffer_size(bucket) if i == last else lf.offset + lf.size
            sizes.append(max(0, min(end, hi) - max(lf.offset, lo)))
        return torch.repeat_interleave(
            per_leaf, torch.tensor(sizes, device=per_leaf.device),
            output_size=hi - lo)

    def empty(self, device) -> dict[str, torch.Tensor]:
        """Uninitialized buckets on `device` (fill them through
        `unflatten`'s views)."""
        return {b: torch.empty(self.buffer_size(b), dtype=self.dtypes[b],
                               device=device) for b in self.buckets}

    def flatten(self, tree: Tree, *, lead: int = 0) -> dict[str, torch.Tensor]:
        """Tree (leaves `[*lead, *shape]`) -> `{bucket: [*lead, N]}` (new
        buffers, concatenated in offset order)."""
        leaves, treedef = T.flatten(tree)
        if treedef != self.treedef:
            raise LayoutError("tree structure does not match the spec's")
        out = {}
        for b in self.buckets:
            parts = []
            for i in self._order[b]:
                x, lf = leaves[i], self._leaves[i]
                if tuple(x.shape[lead:]) != lf.shape:
                    raise LayoutError(
                        f"leaf {i} shape {tuple(x.shape)} (lead={lead}) does "
                        f"not match the spec's {lf.shape}")
                parts.append(x.reshape(tuple(x.shape[:lead]) + (lf.size,)))
            out[b] = torch.cat(parts, dim=lead)
        return out

    def unflatten(self, bufs: dict[str, torch.Tensor], *,
                  lead: int = 0) -> Tree:
        """`{bucket: [*lead, N]}` -> tree of `[*lead, *shape]` leaves, each a
        view into its bucket (writing a leaf writes the bucket)."""
        leaves: list[Any] = [None] * len(self._leaves)
        for b in self.buckets:
            buf = bufs[b]
            if buf.shape[lead] != self.buffer_size(b):
                raise LayoutError(f"bucket {b} has {buf.shape[lead]} elements,"
                                  f" the spec {self.buffer_size(b)}")
            for i in self._order[b]:
                lf = self._leaves[i]
                sl = buf.narrow(lead, lf.offset, lf.size)
                leaves[i] = sl.view(tuple(buf.shape[:lead]) + lf.shape)
        return T.unflatten(self.treedef, leaves)


class ShardedFlatSpace(FlatParamSpace):
    """FlatParamSpace whose buckets split into `shards` contiguous chunks
    (port of the reference's ShardedFlatSpace).

    Each bucket is zero-padded to a multiple of `shards` (W * S: the worker
    count times the shard count, so that both the S storage chunks and the
    W sub-chunks a reduce-scatter leaves each worker fall on whole
    elements).  The pad is invisible to `unflatten` and inert in the
    runtime: pad params, grads and moments start and stay zero, a zero
    delta quantizes to zero, and the pad's segment id (#leaves) lies
    outside every leaf.  With a `mesh` (and the worker / shard axis names)
    the sync runs its collective halves over the mesh's process groups
    (core/sync.py); without one the padded buffers run the flat path."""

    def __init__(self, tree: Tree, shards: int = 1, *, mesh=None,
                 worker_axes: tuple[str, ...] = (),
                 shard_axes: tuple[str, ...] = ()):
        super().__init__(tree)
        if shards < 1:
            raise LayoutError(f"shards must be >= 1, got {shards}")
        self.shards = shards
        self.mesh = mesh
        self.worker_axes = tuple(worker_axes)
        self.shard_axes = tuple(shard_axes)
        self.pad: dict[str, int] = {b: (-n) % shards
                                    for b, n in self.sizes.items()}

    def buffer_size(self, bucket: str) -> int:
        """Padded bucket-buffer length (a multiple of `shards`)."""
        return self.sizes[bucket] + self.pad[bucket]

    def segment_ids(self, bucket: str) -> np.ndarray:
        """The base map extended over the pad with id == #leaves."""
        base = super().segment_ids(bucket)
        ext = np.full(self.pad[bucket], self.bucket_leaves(bucket), np.int32)
        return np.concatenate([base, ext])

    def flatten(self, tree: Tree, *, lead: int = 0) -> dict[str, torch.Tensor]:
        out = super().flatten(tree, lead=lead)
        return {b: F.pad(x, (0, self.pad[b])) if self.pad[b] else x
                for b, x in out.items()}


_STACKED = ("m", "v", "mu")       # optimizer slots carrying the worker axis


def flat_state_slices(run_cfg, spec: ShardedFlatSpace, worker: int,
                      shard: int, n_shards: int) -> Tree:
    """The global slices one rank of a mesh holds of the flat runtime
    state, as a tree beside the state's (the reference's
    `flat_state_specs`, written as a rank's slices, not PartitionSpecs):
    params and the optimizer's m, v and mu are `[W, N]`, chunked over the
    worker axes (row `worker`) and the shard axes (the `shard`-th of
    `n_shards` contiguous chunks); anchor and outer_mu are `[N]`, chunked
    over the shard axes; `step` is replicated (an empty tuple)."""
    def chunk(b):
        c = spec.buffer_size(b) // n_shards
        return slice(shard * c, (shard + 1) * c)

    bufs = lambda lead: {b: lead + (chunk(b),) for b in spec.buckets}  # noqa: E731
    wlead = (slice(worker, worker + 1),)
    slots = ("mu",) if run_cfg.optimizer == "sgd" else ("m", "v")
    out = {"params": bufs(wlead),
           "opt": {**{k: bufs(wlead) for k in slots}, "step": ()}}
    if run_cfg.sync_quantize or run_cfg.outer_momentum > 0.0:
        out["anchor"] = bufs(())
        if run_cfg.outer_momentum > 0.0:
            out["outer_mu"] = bufs(())
    return out


def take_slices(state: Tree, slices: Tree) -> Tree:
    """A rank's state from the whole one: each leaf's slice, copied into
    storage of its own (contiguous and at the allocator's alignment, which
    the kernels' vector loads need; a view would sit at the slice's offset
    and keep the whole state alive)."""
    own = lambda x: x.clone(memory_format=torch.contiguous_format)  # noqa: E731
    return T.map(lambda sl, x: own(x[sl]) if sl else x, slices, state)


# --------------------------------------------------------------------------
# Runtime-state conversion (the RoundEngine's layout="flat" entry points)
# --------------------------------------------------------------------------


def to_flat_state(spec: FlatParamSpace, state: Tree) -> Tree:
    """Tree runtime state (local_update.init_state layout) -> flat state:
    params/opt moments become `{bucket: [W, N]}`, the sync anchor and outer
    momentum become `{bucket: [N]}`; scalars ride along unchanged."""
    out = {"params": spec.flatten(state["params"], lead=1)}
    out["opt"] = {k: (spec.flatten(v, lead=1) if k in _STACKED else v)
                  for k, v in state["opt"].items()}
    for k in ("anchor", "outer_mu"):
        if k in state:
            out[k] = spec.flatten(state[k])
    return out


def to_tree_state(spec: FlatParamSpace, state: Tree) -> Tree:
    """Inverse of `to_flat_state`: every leaf is a view into its bucket."""
    out = {"params": spec.unflatten(state["params"], lead=1)}
    out["opt"] = {k: (spec.unflatten(v, lead=1) if k in _STACKED else v)
                  for k, v in state["opt"].items()}
    for k in ("anchor", "outer_mu"):
        if k in state:
            out[k] = spec.unflatten(state[k])
    return out
