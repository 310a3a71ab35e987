"""Hot weight swap for the serving path: flat-bucket publish/subscribe
(port of `repro/launch/weights.py`).

The train-to-serve contract: a QSR run publishes its consensus params and
a live endpoint swaps them in between decode steps, without restarting.

  * `publish_weights` — the producer side: a params-only checkpoint
    (`checkpoint/io.py`: atomic, durable, step-stamped) tagged
    `serving_weights/v1`, typically written from the async observer's
    thread (`train(..., async_observer=True, eval_fn=...)`).
  * `WeightSubscriber` — the latest-wins slot a producer `publish`es into
    (in process) and `poll()` fills from a `watch_dir` of published
    checkpoints (across processes); the serving thread `take`s from it
    between decode steps.  A superseded offer is dropped: the server only
    ever sees the newest weights.
  * `ServingWeights` — the swap target.  Params live as `FlatParamSpace`
    dtype buckets on the serving device; the model reads views into them,
    so `swap()` is one contiguous copy per dtype bucket, written IN PLACE
    into the same buffers (the views stay valid and no second copy of the
    weights is ever held on the device).  Every swap appends a `SwapEpoch`
    audit row, which makes every emitted token attributable to a weight
    generation (`ContinuousBatcher` stamps each token with it).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import flat
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models import param as pm

WEIGHTS_KIND = "serving_weights/v1"


@dataclasses.dataclass(frozen=True)
class SwapEpoch:
    """One weight generation of a serving process (audit record)."""
    index: int            # 0 = the weights the server started with
    step: int             # producer step of these weights
    source: str           # "init" | "publish" | "watch:<dir>" | ...
    tokens_before: int    # tokens emitted by this server before the swap
    wall_time: float


class ServingWeights:
    """Serving params as FlatParamSpace dtype buckets + swap-epoch audit.

    `tree` is the model's view of the buckets (built once; a swap writes
    through it).  The device is the caller's: None means CUDA, and raises
    when there is no card (`repro_torch.device`)."""

    def __init__(self, cfg, params: Any, *, step: int = 0,
                 source: str = "init", device=None):
        dev = resolve_device(device)
        spec = flat.FlatParamSpace(params)
        self._setup(cfg, spec,
                    {b: v.to(dev) for b, v in spec.flatten(params).items()},
                    step, source)

    @classmethod
    def from_seed(cls, cfg, seed: int, *, device=None, step: int = 0,
                  source: str = "init") -> "ServingWeights":
        """Random weights drawn on the device from `seed`, written straight
        into the buckets through their views: one copy at peak."""
        dev = resolve_device(device)
        defs = api.get_module(cfg).param_defs(cfg)
        spec = flat.FlatParamSpace(pm.abstract_params(defs))
        bufs = spec.empty(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pm.init_params(defs, gen, out=spec.unflatten(bufs))
        return cls.from_buckets(cfg, spec, bufs, step=step, source=source)

    @classmethod
    def from_buckets(cls, cfg, spec, bufs: dict, *, step: int = 0,
                     source: str = "init") -> "ServingWeights":
        """Serving weights over `spec`'s dtype buckets `bufs` as they are:
        no copy (the device is the buckets')."""
        self = cls.__new__(cls)
        self._setup(cfg, spec, bufs, step, source)
        return self

    def _setup(self, cfg, spec, bufs, step, source):
        self.cfg = cfg
        self.spec = spec
        self.bufs = bufs
        self.device = next(iter(bufs.values())).device
        self.tree = spec.unflatten(bufs)
        self.step = step
        self.epochs: list[SwapEpoch] = [
            SwapEpoch(0, step, source, 0, time.time())]

    @property
    def epoch(self) -> int:
        return self.epochs[-1].index

    def as_tree(self) -> Any:
        """Current weights as the model tree (views into the buckets)."""
        return self.tree

    def swap(self, params: Any, *, step: int, source: str = "publish",
             tokens_before: int = 0) -> SwapEpoch:
        """Replace the serving weights in place: one contiguous copy per
        dtype bucket.  `params` must match the spec's tree (same shapes and
        dtypes — a different architecture is a deploy, not a swap)."""
        new = self.spec.flatten(params)
        for b in self.spec.buckets:
            self.bufs[b].copy_(new[b])
        self.step = step
        ep = SwapEpoch(self.epoch + 1, step, source, tokens_before,
                       time.time())
        self.epochs.append(ep)
        return ep

    def audit(self) -> list[dict]:
        """The swap-epoch trail as JSON-able rows."""
        return [dataclasses.asdict(e) for e in self.epochs]


def params_like(cfg) -> Any:
    """Host fp32 tensors shaped as the model's params: the `like` a
    WeightSubscriber restores published checkpoints into.  Only their
    shapes, dtype and device are read, so they are left uninitialized
    (`torch.empty`: no host memory is touched for them)."""
    return T.map(lambda d: torch.empty(d.shape, dtype=torch.float32),
                 api.get_module(cfg).param_defs(cfg))


def publish_weights(path: str, params: Any, *, step: int,
                    extra: dict | None = None) -> None:
    """Write a params-only serving checkpoint (atomic and durable, through
    checkpoint/io.py), its extra tagged with WEIGHTS_KIND and the time."""
    meta = {"kind": WEIGHTS_KIND, "published_at": time.time()}
    meta.update(extra or {})
    ckpt_io.save(path, params, step=step, extra=meta)


def load_weights(path: str, like: Any) -> tuple[Any, int, dict]:
    """Restore a published serving checkpoint into `like`'s shapes,
    dtypes and devices.  Returns (params, step, extra)."""
    tree, step, extra = ckpt_io.restore_with_meta(path, like)
    return tree, int(step or 0), extra


class WeightSubscriber:
    """Latest-wins weight feed for a serving process.

    Thread contract: `publish()` may be called from any thread (the async
    observer's, typically); `poll()` and `take()` belong to the serving
    thread.  The slot holds host copies so the producer's device buffers
    are never retained.  With a `watch_dir`, `poll()` restores the newest
    published checkpoint there into `like` (see `params_like`)."""

    def __init__(self, *, watch_dir: str | None = None,
                 like: Any | None = None):
        self.watch_dir = watch_dir
        self._like = like
        self._lock = threading.Lock()
        self._latest: tuple[int, str, Any] | None = None
        self._seen_step: int | None = None
        self.superseded = 0           # snapshots dropped by latest-wins

    # -- producer side -----------------------------------------------------

    def publish(self, step: int, params: Any, *,
                source: str = "publish") -> None:
        """Offer new weights (in-process path), staged to host memory;
        latest-wins on `step`."""
        host = T.map(lambda t: t.detach().to("cpu", copy=True), params)
        self._offer(int(step), source, host)

    # -- serving side ------------------------------------------------------

    def poll(self) -> None:
        """Check the watch_dir for a newer published checkpoint and load it
        into the slot.  A missing or half-replaced file is retried on the
        next poll (checkpoint/io.py writes are atomic, so a finished file
        is always whole)."""
        if self.watch_dir is None:
            return
        meta = ckpt_io.try_read_meta(self.watch_dir)
        if meta is None:
            return
        step = meta[0]
        if step is None or (self._seen_step is not None
                            and int(step) <= self._seen_step):
            return
        if self._like is None:
            raise ValueError("WeightSubscriber with a watch_dir needs a "
                             "`like` tree to restore into (see params_like)")
        try:
            tree, got_step, _ = ckpt_io.restore_with_meta(self.watch_dir,
                                                          self._like)
        except (ckpt_io.CheckpointError, FileNotFoundError):
            return                     # mid-replace; next poll sees it whole
        got_step = int(got_step if got_step is not None else step)
        self._seen_step = got_step
        self._offer(got_step, f"watch:{self.watch_dir}", tree)

    def take(self) -> tuple[int, str, Any] | None:
        """Pop the newest offered weights, or None.  The swap point calls
        this between decode steps (ContinuousBatcher.maybe_swap)."""
        with self._lock:
            got, self._latest = self._latest, None
        return got

    def _offer(self, step: int, source: str, tree: Any) -> None:
        with self._lock:
            if self._latest is not None:
                if step <= self._latest[0]:
                    return             # older than what's already queued
                self.superseded += 1
            self._latest = (step, source, tree)
