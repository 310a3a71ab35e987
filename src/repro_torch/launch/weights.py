"""Hot weight swap for the serving path: flat-bucket publish/subscribe
(port of `repro/launch/weights.py`, in-process half).

  * `ServingWeights` — the swap target.  Params live as `FlatParamSpace`
    dtype buckets on the serving device; the model reads views into them,
    so `swap()` is one contiguous copy per dtype bucket, written IN PLACE
    into the same buffers (the views stay valid and no second copy of the
    weights is ever held on the device).  Every swap appends a `SwapEpoch`
    audit row, which makes every emitted token attributable to a weight
    generation (`ContinuousBatcher` stamps each token with it).
  * `WeightSubscriber` — the latest-wins slot a producer thread `publish`es
    into and the serving thread `take`s from between decode steps.

The cross-process half of the reference — `publish_weights`/`load_weights`
checkpoints and `WeightSubscriber.poll` of a watch dir — needs the
checkpoint module and waits for it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.core import flat
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models import param as pm


@dataclasses.dataclass(frozen=True)
class SwapEpoch:
    """One weight generation of a serving process (audit record)."""
    index: int            # 0 = the weights the server started with
    step: int             # producer step of these weights
    source: str           # "init" | "publish" | ...
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


class WeightSubscriber:
    """Latest-wins weight feed for a serving process.

    Thread contract: `publish()` may be called from any thread; `take()`
    belongs to the serving thread.  The slot holds host copies so the
    producer's device buffers are never retained."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latest: tuple[int, str, Any] | None = None
        self.superseded = 0           # snapshots dropped by latest-wins

    def publish(self, step: int, params: Any, *,
                source: str = "publish") -> None:
        """Offer new weights (in-process path), staged to host memory;
        latest-wins on `step`."""
        host = T.map(lambda t: t.detach().to("cpu", copy=True), params)
        with self._lock:
            if self._latest is not None:
                if step <= self._latest[0]:
                    return             # older than what's already queued
                self.superseded += 1
            self._latest = (int(step), source, host)

    def take(self) -> tuple[int, str, Any] | None:
        """Pop the newest offered weights, or None.  The swap point calls
        this between decode steps (ContinuousBatcher.maybe_swap)."""
        with self._lock:
            got, self._latest = self._latest, None
        return got
