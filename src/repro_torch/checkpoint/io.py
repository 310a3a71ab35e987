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


def _read_payload(path: str, name: str) -> dict:
    """Unpack one checkpoint file; a torn, truncated or corrupt payload
    raises CheckpointError (a missing file FileNotFoundError).  Bin values
    come back as memoryviews into the file's bytes: array data is copied
    once, by `_decode`, and `_bytes` makes the rest bytes."""
    fname = os.path.join(path, name)
    with open(fname, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
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
            got = got.to(device=want.device, dtype=want.dtype)
        out.append(got)
    return (T.unflatten(treedef, out), _bytes(payload.get("step")),
            _bytes(payload.get("extra") or {}))


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
