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
`ShardedFlatSpace` waits for the distributed slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

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
        return torch.stack([x.narrow(0, self._leaves[i].offset,
                                     self._leaves[i].size).max()
                            for i in self._order[bucket]])

    def spread(self, bucket: str, per_leaf: torch.Tensor) -> torch.Tensor:
        """Per-tensor values `[#leaves]` -> elements `[N]` (each leaf's
        value repeated over its elements)."""
        sizes = torch.tensor([self._leaves[i].size for i in self._order[bucket]],
                             device=per_leaf.device)
        return torch.repeat_interleave(per_leaf, sizes,
                                       output_size=self.sizes[bucket])

    def empty(self, device) -> dict[str, torch.Tensor]:
        """Uninitialized buckets on `device` (fill them through
        `unflatten`'s views)."""
        return {b: torch.empty(self.sizes[b], dtype=self.dtypes[b],
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
            if buf.shape[lead] != self.sizes[b]:
                raise LayoutError(f"bucket {b} has {buf.shape[lead]} elements,"
                                  f" the spec {self.sizes[b]}")
            for i in self._order[b]:
                lf = self._leaves[i]
                sl = buf.narrow(lead, lf.offset, lf.size)
                leaves[i] = sl.view(tuple(buf.shape[:lead]) + lf.shape)
        return T.unflatten(self.treedef, leaves)


# --------------------------------------------------------------------------
# Runtime-state conversion (the RoundEngine's layout="flat" entry points)
# --------------------------------------------------------------------------

_STACKED = ("m", "v", "mu")       # optimizer slots carrying the worker axis


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
