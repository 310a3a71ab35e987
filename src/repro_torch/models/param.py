"""Declarative parameter definitions (port of `repro/models/param.py`).

Every model module describes its parameters once, as a nested dict of
``ParamDef(shape, logical_axes, init)``.  From that description come:

  * ``init_params``      — materialized tree, drawn from a `torch.Generator`
                           (optionally straight into caller-given views,
                           which is how `ServingWeights.from_seed` fills its
                           flat buckets without a second copy);
  * ``abstract_params``  — the same tree as `meta` tensors (shapes/dtypes);
  * ``count_params``;
  * ``from_numpy_tree``  — the JAX package's params carried across as numpy.

The sharding policies' worker axes (`worker_count`, `worker_mesh_axes`,
over `launch/mesh.py`'s Mesh) name which mesh axes carry the divergent
replicas; per-tensor sharding specs (`param_specs`) have no counterpart: a
rank of the port keeps contiguous chunks of flat buckets instead
(`core/flat.py ShardedFlatSpace`).  A
`torch.Generator` and `jax.random` give different numbers from one seed:
tests that need both packages on the same weights carry them across with
`from_numpy_tree`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.errors import ShapeError

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ShapeError(
                f"ParamDef shape {self.shape} and axes {self.axes} "
                "must have equal rank")


def _leaf_init(out: torch.Tensor, d: ParamDef,
               gen: torch.Generator) -> torch.Tensor:
    """Fill `out` in place with `d`'s init (same rules as the JAX package's
    `_leaf_init`: lecun-normal over fan-in = shape[-2] for "normal")."""
    if d.init == "zeros":
        return out.zero_()
    if d.init == "ones":
        return out.fill_(1.0)
    if d.init == "embed":
        return out.normal_(0.0, d.scale, generator=gen)
    if d.init == "normal":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        return out.normal_(0.0, std, generator=gen)
    raise ShapeError(f"unknown init {d.init!r}")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def init_params(defs: Tree, gen: torch.Generator, dtype=torch.float32, *,
                device=None, out: Tree | None = None) -> Tree:
    """Draw every leaf from `gen`, in sorted-key leaf order.

    `out`, when given, is a tree of tensors matching `defs` (for example
    views into flat buckets) that is filled in place and returned; otherwise
    fresh tensors are allocated on `device` (default: `gen`'s device)."""
    leaves, treedef = T.flatten(defs)
    if out is None:
        dev = gen.device if device is None else device
        targets = [torch.empty(d.shape, dtype=dtype, device=dev)
                   for d in leaves]
    else:
        targets, out_def = T.flatten(out)
        if out_def != treedef:
            raise ShapeError("`out` tree does not match the ParamDef tree")
    for t, d in zip(targets, leaves):
        if tuple(t.shape) != d.shape:
            raise ShapeError(f"`out` leaf {tuple(t.shape)} != def {d.shape}")
        _leaf_init(t, d, gen)
    return T.unflatten(treedef, targets)


def abstract_params(defs: Tree, dtype=torch.float32) -> Tree:
    """Shape/dtype-only tree (`meta` tensors, no storage)."""
    return T.map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                 defs)


def count_params(defs: Tree) -> int:
    return sum(math.prod(d.shape) for d in T.leaves(defs))


def from_numpy_tree(tree: Tree, device) -> Tree:
    """A nested dict of numpy arrays (for example the JAX package's params
    after `jax.tree.map(np.asarray, params)`) -> the same tree of torch
    tensors on `device`, at the same key paths, values copied exactly."""
    return T.map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(device),
                 tree)


# --------------------------------------------------------------------------
# Sharding policies: which mesh axes carry the workers
# --------------------------------------------------------------------------

# the "worker" entries of the reference's _POLICY_RULES: dp has one model
# replica per data rank (and pod), fsdp one per pod
_POLICY_RULES: dict[str, list[tuple[str, tuple[str, ...]]]] = {
    "dp": [("worker", ("pod", "data"))],
    "fsdp": [("worker", ("pod",))],
}


def _worker_rule(policy: str) -> tuple[str, ...]:
    if policy not in _POLICY_RULES:
        raise ShapeError(f"unknown sharding policy {policy!r}; pick from "
                         f"{sorted(_POLICY_RULES)}")
    return dict(_POLICY_RULES[policy])["worker"]


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.dims))


def worker_count(policy: str, mesh) -> int:
    """Number of local-gradient workers (divergent replicas) for a
    policy on a mesh."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in _worker_rule(policy))


def worker_mesh_axes(policy: str, mesh) -> tuple[str, ...]:
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in _worker_rule(policy) if a in sizes)
