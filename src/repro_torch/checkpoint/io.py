"""Tree checkpoints in the JAX package's format (port of
`repro/checkpoint/io.py`, the monolithic half).

A checkpoint is a directory holding `state.msgpack` (the tree's leaves, its
step and an `extra` dict of run metadata) and `meta.msgpack` (step and
extra alone, so `read_meta` never unpacks the state).  Each array leaf is a
record `{b"__nd__": True, b"dtype": "<f4", b"shape": [...], b"data":
<raw little-endian bytes>}`; other leaves (ints, floats, strings) are stored
as they are.  The port writes these files byte for byte as the reference
does for the same tree and extra, and each package restores the other's:
leaves are taken in `repro_torch.tree.flatten` order (dict keys sorted at
every level, `jax.tree.flatten`'s order for nested dicts) and the treedef
is written as `str(treedef)` prints it.  The msgpack subset is read and
written by `checkpoint/wire.py`, with the standard library.

Dtypes: the tags the port's paths write are `<f4`, `<i4`, `<i8`, `|i1` and
`|u1`; another tag raises CheckpointError naming it.

Durability: every file lands via tmp write + fsync + `os.replace` +
directory fsync (`_write_atomic`), so a crash leaves the previous
checkpoint or the new one, never a torn file.  Readers raise
CheckpointError (a real exception: asserts vanish under `python -O`) on a
torn payload or a shape or leaf-count mismatch.

The sharded manifest checkpoints (`save_sharded` / `restore_sharded`) wait
for the distributed slice.
"""
from __future__ import annotations

import dataclasses
import math
import mmap
import os
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import wire


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be restored as claimed: a torn or truncated
    payload, an unknown dtype, or a shape or leaf-count mismatch against
    the `like` tree."""


# dtype tag (numpy's `dtype.str`) <-> torch dtype, for the ported paths
_TAGS = {"<f4": torch.float32, "<i4": torch.int32, "<i8": torch.int64,
         "|i1": torch.int8, "|u1": torch.uint8}
_TAG_OF = {v: k for k, v in _TAGS.items()}


def _encode(x):
    """A tensor -> its array record (the data a view of the host copy's
    bytes); any other value as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _TAG_OF:
            raise CheckpointError(f"cannot checkpoint dtype {x.dtype}: the "
                                  f"format's tags here are {sorted(_TAGS)}")
        a = x.detach().cpu().contiguous().numpy()
        return {b"__nd__": True, b"dtype": _TAG_OF[x.dtype],
                b"shape": list(a.shape),
                b"data": memoryview(a.reshape(-1).view(np.uint8))}
    return x


def _decode(obj):
    """An array record -> CPU tensor; any other value as it is."""
    if not (isinstance(obj, dict) and (b"__nd__" in obj or "__nd__" in obj)):
        return obj

    def get(k):
        v = obj.get(k.encode())
        return v if v is not None else obj.get(k)

    tag, shape, data = get("dtype"), get("shape"), get("data")
    if not isinstance(tag, str) or tag not in _TAGS:
        raise CheckpointError(f"checkpoint leaf has dtype tag {tag!r}, "
                              f"not one of {sorted(_TAGS)}")
    if not isinstance(data, (bytes, memoryview)) or \
            not isinstance(shape, list):
        raise CheckpointError("checkpoint array record without its shape "
                              "or data")
    if len(data) % np.dtype(tag).itemsize:
        raise CheckpointError(f"checkpoint leaf of {len(data)} bytes is not "
                              f"a whole number of {tag} elements")
    a = np.frombuffer(data, dtype=np.dtype(tag))
    try:
        a = a.reshape(shape)
    except (ValueError, TypeError) as e:
        raise CheckpointError(f"checkpoint leaf of {a.size} elements does "
                              f"not fill shape {shape}") from e
    return torch.from_numpy(a.copy())


def _treedef_str(treedef) -> str:
    """`str(treedef)` of `jax.tree.flatten` for a tree of nested dicts."""
    def render(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(v)}"
                                   for k, v in t.items()) + "}"
        return "*"
    return f"PyTreeDef({render(treedef)})"


def stage(tree: Any) -> Any:
    """Device tree -> host tree: every tensor leaf copied to the CPU (a CPU
    leaf passes as it is), other leaves unchanged.  The async observer's
    worker thread stages its snapshots here (core/observer.py)."""
    return T.map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor)
                 else x, tree)


def _write_atomic(path: str, name: str, payload) -> None:
    """Crash-durable file publish of `payload` packed as msgpack: tmp write
    + fsync(file) + os.replace + fsync(directory).  Without the file fsync
    a crash after the rename can surface a zero-length file; without the
    directory fsync the rename itself can be lost.  Either way the previous
    version stays whole.  Array data is written from the host copy's
    buffer, not copied into a packed stream first (`wire.dump`)."""
    tmp = os.path.join(path, name + ".tmp")
    with open(tmp, "wb") as f:
        try:
            wire.dump(payload, f.write)
        except wire.WireError as e:
            raise CheckpointError(f"cannot serialize the checkpoint: {e}") \
                from e
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, name))
    dfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save(path: str, tree: Any, *, step: int | None = None,
         extra: dict | None = None) -> None:
    """Write `tree` (nested dicts of tensors or plain values) with its
    step and `extra` (free-form run metadata, e.g. the RoundEngine's
    H-trace).  Tensors are copied to the host here."""
    os.makedirs(path, exist_ok=True)
    leaves, treedef = T.flatten(tree)
    payload = {"treedef": _treedef_str(treedef), "step": step,
               "extra": extra or {},
               "leaves": [_encode(x) for x in leaves]}
    _write_atomic(path, "state.msgpack", payload)
    # small side file so read_meta() never has to unpack the state payload
    _write_atomic(path, "meta.msgpack", {"step": step, "extra": extra or {}})


def layout_meta(layout: str, spec=None) -> dict:
    """Param-layout fields for a checkpoint's `extra` dict: the layout and,
    for the flat layout, its dtype buckets' sizes (what a reader needs to
    reinterpret or convert the buffers)."""
    out: dict = {"layout": layout}
    if spec is not None:
        out["buckets"] = {b: spec.sizes[b] for b in spec.buckets}
        shards = getattr(spec, "shards", None)
        if shards is not None:
            out["shards"] = shards
    return out


def restore(path: str, like: Any) -> tuple[Any, int | None]:
    """Restore into the structure of `like` (shapes validated)."""
    tree, step, _ = restore_with_meta(path, like)
    return tree, step


def _read_payload(path: str, name: str, *, mapped: bool = False) -> dict:
    """Unpack one checkpoint file; a torn, truncated or corrupt payload
    raises CheckpointError (a missing file FileNotFoundError).  Bin values
    come back as memoryviews into the file's bytes (`mapped`: into a
    read-only map of the file): array data is copied once, by `_decode`,
    and `_bytes` makes the rest bytes."""
    fname = os.path.join(path, name)
    with open(fname, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if mapped and size:
            # the pages a caller copies out are the only ones read
            data, n = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ), size
        else:
            data = bytearray(size)
            n = f.readinto(data)
    try:
        payload = wire.unpackb(memoryview(data)[:n], bin_views=True)
    except wire.WireError as e:
        raise CheckpointError(f"torn or corrupt checkpoint file {fname}: "
                              f"{e}") from e
    if not isinstance(payload, dict):
        raise CheckpointError(f"torn or corrupt checkpoint file {fname}: "
                              f"payload is {type(payload).__name__}")
    return payload


def restore_with_meta(path: str, like: Any) -> tuple[Any, int | None, dict]:
    """Like `restore`, plus the `extra` dict.  Tensor leaves of `like`
    give the restored leaf its dtype and device; a shape or leaf-count
    mismatch raises CheckpointError."""
    payload = _read_payload(path, "state.msgpack")
    leaves_like, treedef = T.flatten(like)
    raw = payload.get("leaves") or []
    if not isinstance(raw, list) or len(raw) != len(leaves_like):
        n = len(raw) if isinstance(raw, list) else type(raw).__name__
        raise CheckpointError(
            f"checkpoint at {path} holds {n} leaves, the target structure "
            f"expects {len(leaves_like)}")
    out = []
    for got, want in zip(raw, leaves_like):
        got = _bytes(_decode(got))
        if isinstance(want, torch.Tensor):
            shape = tuple(want.shape)
            if not isinstance(got, torch.Tensor) or tuple(got.shape) != shape:
                have = (tuple(got.shape) if isinstance(got, torch.Tensor)
                        else type(got).__name__)
                raise CheckpointError(
                    f"checkpoint leaf {have} does not match the target "
                    f"shape {shape}")
            got = _place(got, want)
        out.append(got)
    return (T.unflatten(treedef, out), _bytes(payload.get("step")),
            _bytes(payload.get("extra") or {}))


def _place(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """A restored leaf at `want`'s dtype, on its device; a `meta` target
    (a shape template) leaves it on the CPU."""
    if want.device.type == "meta":
        return got.to(dtype=want.dtype)
    return got.to(device=want.device, dtype=want.dtype)


def _bytes(obj):
    """`obj` with every memoryview (a bin read as a view) made bytes, as
    the reference's reader returns it."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, list):
        return [_bytes(x) for x in obj]
    if isinstance(obj, dict):
        return {_bytes(k): _bytes(v) for k, v in obj.items()}
    return obj


def read_meta(path: str) -> tuple[int | None, dict]:
    """(step, extra) from the small meta side file (or, for a checkpoint
    without one, from the state payload)."""
    meta = os.path.join(path, "meta.msgpack")
    src = "meta.msgpack" if os.path.exists(meta) else "state.msgpack"
    payload = _read_payload(path, src)
    return _bytes(payload.get("step")), _bytes(payload.get("extra") or {})


def try_read_meta(path: str) -> tuple[int | None, dict] | None:
    """`read_meta` for watch loops that race a writer: None instead of an
    error while the checkpoint is absent or unreadable; the next poll sees
    it whole (every file lands through `_write_atomic`)."""
    try:
        return read_meta(path)
    except (OSError, CheckpointError):
        return None


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "state.msgpack"))


# --------------------------------------------------------------------------
# Sharded manifest checkpoints (module docstring)
# --------------------------------------------------------------------------

Block = tuple[tuple[int, int], ...]     # (start, stop) per dimension


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where the ranks hold one leaf of a sharded state: the leaf's global
    shape and, rank by rank, the global block that rank's tensor is (one
    (start, stop) pair a dimension; a 0-d leaf's block is `()`)."""
    shape: tuple[int, ...]
    blocks: tuple[Block, ...]

    def owners(self) -> dict[Block, int]:
        """block -> the lowest rank holding it."""
        out: dict[Block, int] = {}
        for rank, blk in enumerate(self.blocks):
            out.setdefault(blk, rank)
        return out


def _shard_fname(step, pid: int) -> str:
    # step-stamped so a writer killed mid-save never clobbers the shard
    # files the previous manifest still names
    return f"shards-{int(step or 0):08d}-{pid:05d}.msgpack"


def _tag(x: torch.Tensor) -> str:
    if x.dtype not in _TAG_OF:
        raise CheckpointError(f"cannot checkpoint dtype {x.dtype}: the "
                              f"format's tags here are {sorted(_TAGS)}")
    return _TAG_OF[x.dtype]


def _raw(x: torch.Tensor) -> memoryview:
    """A tensor's bytes (little-endian, C order) as a view of its host
    copy."""
    a = x.detach().cpu().contiguous().numpy()
    return memoryview(a.reshape(-1).view(np.uint8))


def save_sharded(path: str, tree: Any, *, step: int | None = None,
                 extra: dict | None = None, barrier=None,
                 placement: Any = None, rank: int = 0) -> None:
    """Write this rank's shard file: the blocks it owns of every tensor leaf
    of `tree`.  `placement` is a tree beside `tree` with a `Placement` for
    every tensor leaf (each leaf of `tree` then is block `rank` of it), or
    None for one process's state (whole leaves, written by rank 0).  Rank 0
    then writes the manifest and meta file and deletes the shard files the
    manifest does not name; `barrier` (a zero-argument callable, e.g. the
    mesh's `barrier`) runs between the two, so the manifest never names a
    file that is not yet durable.  Every file lands via `_write_atomic`."""
    os.makedirs(path, exist_ok=True)
    leaves, treedef = T.flatten(tree)
    places = (T.flatten(placement)[0] if placement is not None
              else [None] * len(leaves))
    if len(places) != len(leaves):
        raise CheckpointError(f"{len(places)} placements for {len(leaves)} "
                              "leaves")
    nproc = next((len(p.blocks) for p in places if p is not None), 1)
    man_leaves: list = []           # per-leaf shape/dtype (or inline value)
    fmap: dict = {}                 # fname -> [[leaf, block], ...]
    mine: list = []                 # this rank's entries
    for li, (x, pl) in enumerate(zip(leaves, places)):
        if not isinstance(x, torch.Tensor):
            man_leaves.append({"kind": "value", "value": x})
            continue
        if pl is None:
            pl = Placement(tuple(x.shape), (tuple((0, n) for n in x.shape),))
        man_leaves.append({"kind": "array", "shape": list(pl.shape),
                           "dtype": _tag(x)})
        for blk, owner in sorted(pl.owners().items()):
            ser = [list(se) for se in blk]
            fmap.setdefault(_shard_fname(step, owner), []).append([li, ser])
            if owner == rank:
                if tuple(x.shape) != tuple(e - s for s, e in blk):
                    raise CheckpointError(
                        f"leaf {li}: rank {rank}'s tensor {tuple(x.shape)} "
                        f"is not its block {blk}")
                mine.append([li, ser, _raw(x)])
    _write_atomic(path, _shard_fname(step, rank), {"entries": mine})
    if barrier is not None:
        barrier()
    if rank == 0:
        _write_atomic(path, "manifest.msgpack", {
            "treedef": _treedef_str(treedef), "step": step,
            "extra": extra or {}, "leaves": man_leaves, "files": fmap,
            "process_count": nproc})
        _write_atomic(path, "meta.msgpack",
                      {"step": step, "extra": extra or {}})
        # retire shard files no manifest names anymore (older steps)
        for f in os.listdir(path):
            if (f.startswith("shards-") and f.endswith(".msgpack")
                    and f not in fmap):
                os.unlink(os.path.join(path, f))


def restore_sharded(path: str, like: Any, *,
                    blocks: Any = None) -> tuple[Any, int | None, dict]:
    """Re-stitch a `save_sharded` checkpoint written under any process count
    into the structure of `like` -> (tree, step, extra).  Without `blocks`
    every tensor leaf is the whole leaf, assembled from every file; with
    `blocks` (a tree beside `like`: each tensor leaf's global block) it is
    that block alone, and only the files holding an entry that overlaps a
    wanted block are opened.  Tensor leaves of `like` give the dtype and
    device (`meta`: the CPU).  Raises CheckpointError on a torn manifest or
    shard file, a missing shard file, incomplete coverage, or a leaf count
    or shape that does not match the target."""
    man = _read_payload(path, "manifest.msgpack")
    leaves_like, treedef = T.flatten(like)
    wanted = (T.flatten(blocks)[0] if blocks is not None
              else [None] * len(leaves_like))
    man_leaves = man.get("leaves") or []
    if not isinstance(man_leaves, list) or \
            len(man_leaves) != len(leaves_like):
        n = (len(man_leaves) if isinstance(man_leaves, list)
             else type(man_leaves).__name__)
        raise CheckpointError(
            f"manifest at {path} holds {n} leaves, the target structure "
            f"expects {len(leaves_like)}")
    bufs: list = []                 # numpy buffer, or an inline value
    origin: list = []               # the buffer's global block
    for li, (ml, want, blk) in enumerate(zip(man_leaves, leaves_like,
                                             wanted)):
        if ml.get("kind") == "value":
            bufs.append(_bytes(ml.get("value")))
            origin.append(None)
            continue
        shape = tuple(ml.get("shape") or ())
        tag = ml.get("dtype")
        if tag not in _TAGS:
            raise CheckpointError(f"manifest leaf {li} has dtype tag "
                                  f"{tag!r}, not one of {sorted(_TAGS)}")
        if blk is None:
            blk = tuple((0, n) for n in shape)
        elif len(blk) != len(shape) or any(
                not 0 <= s <= e <= n for (s, e), n in zip(blk, shape)):
            raise CheckpointError(f"leaf {li}: block {blk} is not inside "
                                  f"the manifest's shape {shape}")
        ext = tuple(e - s for s, e in blk)
        if isinstance(want, torch.Tensor) and tuple(want.shape) != ext:
            what = "block" if blocks is not None else "leaf shape"
            raise CheckpointError(
                f"manifest {what} {ext} does not match the target shape "
                f"{tuple(want.shape)}")
        bufs.append(np.empty(ext, np.dtype(tag)))
        origin.append(blk)
    files = man.get("files") or {}
    filled = [0] * len(bufs)
    for fname in sorted(files):
        if not any(_overlap(origin[li], ser) is not None
                   for li, ser in files[fname]
                   if 0 <= li < len(bufs) and origin[li] is not None):
            continue
        try:
            shard = _read_payload(path, fname, mapped=True)
        except FileNotFoundError as e:
            raise CheckpointError(f"manifest at {path} names a missing "
                                  f"shard file {fname}") from e
        for li, ser, data in shard.get("entries") or []:
            if not 0 <= li < len(bufs) or origin[li] is None:
                raise CheckpointError(f"shard file {fname} has an entry for "
                                      f"leaf {li}, which holds no array")
            filled[li] += _paste(bufs[li], origin[li], ser, data, fname)
    out = []
    for li, (buf, want) in enumerate(zip(bufs, leaves_like)):
        if origin[li] is None:
            out.append(buf)
            continue
        if filled[li] != buf.size:
            raise CheckpointError(
                f"leaf {li}: shard files cover {filled[li]} of {buf.size} "
                f"elements — missing or torn shard file")
        got = torch.from_numpy(buf)
        out.append(_place(got, want) if isinstance(want, torch.Tensor)
                   else got)
    return (T.unflatten(treedef, out), _bytes(man.get("step")),
            _bytes(man.get("extra") or {}))


def _overlap(blk, ser):
    """The intersection of two global blocks ((start, stop) per dimension)
    as (lo, hi) lists, or None when it is empty (0-d blocks always meet)."""
    if len(blk) != len(ser):
        return None
    lo = [max(a, s) for (a, _), (s, _) in zip(blk, ser)]
    hi = [min(b, e) for (_, b), (_, e) in zip(blk, ser)]
    if any(x >= y for x, y in zip(lo, hi)):
        return None
    return lo, hi


def _paste(buf: np.ndarray, blk, ser, data, fname: str) -> int:
    """Copy the part of entry `ser` (its bytes `data`) that falls in `buf`
    (global block `blk`); returns the elements copied."""
    try:
        ser = [(int(s), int(e)) for s, e in ser]
        if len(ser) != len(blk):
            raise ValueError(f"a {len(ser)}-d entry for a {len(blk)}-d leaf")
        piece = np.frombuffer(data, dtype=buf.dtype).reshape(
            [e - s for s, e in ser])
    except (TypeError, ValueError) as e:
        raise CheckpointError(f"torn or corrupt entry in shard file "
                              f"{fname}: {e}") from e
    hit = _overlap(blk, ser)
    if hit is None:
        return 0
    lo, hi = hit
    dst = tuple(slice(a - b0, b - b0) for a, b, (b0, _) in zip(lo, hi, blk))
    src = tuple(slice(a - s0, b - s0) for a, b, (s0, _) in zip(lo, hi, ser))
    buf[dst] = piece[src]
    return math.prod(b - a for a, b in zip(lo, hi))


def is_manifest(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.msgpack"))


def read_manifest_meta(path: str) -> tuple[int | None, dict]:
    """(step, extra) of a manifest checkpoint: from the meta side file
    (rank 0 writes it with the manifest), else the manifest itself."""
    if os.path.exists(os.path.join(path, "meta.msgpack")):
        return read_meta(path)
    man = _read_payload(path, "manifest.msgpack")
    return _bytes(man.get("step")), _bytes(man.get("extra") or {})
