r"""AsyncObserver: eval and checkpoints off the round loop's critical path
(port of `repro/core/observer.py`).

A round loop that stops to copy a state snapshot to the host, run eval and
write a checkpoint serializes exactly the latency the overlapped sync
removes.  Observers run on a background host thread instead, fed by
`RoundEngine.synced_view(state)`, so training never blocks on host I/O.

## Snapshots on the card

The port updates its state in place (the AdamW kernel, the sync kernels),
so a snapshot that aliased the live state's buffers would change under the
worker as the next round runs.  `submit` therefore clones every tensor of
the snapshot ON ITS DEVICE, on the submitting (round loop's) thread: the
clones are enqueued on the current stream before any later in-place
update, so they hold the state as it was at submit, and the host never
waits for them.  An event recorded behind the clones tells the worker when
they are done; it waits for that event, stages the clones to the host
(`checkpoint/io.py stage`) and runs the handler.  The cost is one device
copy of the snapshot per submit, and at
most two snapshots alive beside the state (one being handled, one queued).

## Double buffering

At most one snapshot is in flight (being handled) and one queued.  A
submit that finds the queue slot full REPLACES the queued snapshot
(latest-wins) instead of blocking, and `dropped` counts the superseded
ones; the optional `merge` hook folds must-not-drop flags of the superseded
snapshot (a pending checkpoint request) into the newer one.  `drain()`
blocks until everything submitted has been handled; handler exceptions are
re-raised there and by `close()`, never swallowed.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from repro_torch import tree as T


def fanout(*handlers: Callable[[int, Any], None]) -> Callable[[int, Any], None]:
    """Compose observer handlers: one AsyncObserver feeding several
    consumers (the checkpoint writer AND `publish_weights`, say), so the
    snapshot is staged once and every consumer sees the same host tree.
    Handlers run in order on the worker thread; the first exception
    propagates (raised at drain/close), so order the critical consumer
    first."""
    def handler(step: int, snapshot: Any) -> None:
        for h in handlers:
            h(step, snapshot)
    return handler


def clone_on_device(tree: Any) -> tuple[Any, list]:
    """(every tensor leaf cloned where it lies, detached, other leaves as
    they are; the CUDA events recorded behind the clones, one per device).
    Asynchronous on the card."""
    out = T.map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor)
                else x, tree)
    devs = {x.device for x in T.leaves(out)
            if isinstance(x, torch.Tensor) and x.is_cuda}
    events = []
    for dev in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return out, events


class AsyncObserver:
    """Background worker for eval/checkpoint observers (double-buffered).

    handler(step, snapshot) runs on the worker thread with the submitted
    snapshot staged to the host by `stage` (default `checkpoint.io.stage`);
    `submit` clones the snapshot's tensors on their device first (module
    docstring)."""

    def __init__(self, handler: Callable[[int, Any], None], *,
                 stage: Callable[[Any], Any] | None = None,
                 merge: Callable[[Any, Any], Any] | None = None):
        from repro_torch.checkpoint import io as ckpt_io
        self._handler = handler
        self._stage = ckpt_io.stage if stage is None else stage
        self._merge = merge
        self._cv = threading.Condition()
        self._queued: tuple[int, Any, list] | None = None
        self._busy = False
        self._closed = False
        self._error: BaseException | None = None
        self.submitted = 0
        self.processed = 0
        self.dropped = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-torch-observer")
        self._thread.start()

    # -- round-loop side ---------------------------------------------------

    def submit(self, step: int, snapshot: Any) -> None:
        """Clone the snapshot on its device and hand it to the worker.
        Never waits for observer work: a snapshot still queued is
        superseded (latest-wins, through `merge` when given)."""
        snapshot, ready = clone_on_device(snapshot)
        with self._cv:
            if self._closed:
                raise RuntimeError("observer is closed")
            self._reraise()
            if self._queued is not None:
                self.dropped += 1
                if self._merge is not None:
                    snapshot = self._merge(self._queued[1], snapshot)
                    ready = self._queued[2] + ready
            self._queued = (step, snapshot, ready)
            self.submitted += 1
            self._cv.notify_all()

    def drain(self) -> None:
        """Block until every submitted snapshot has been handled; re-raise
        the first handler error if any."""
        with self._cv:
            self._cv.wait_for(lambda: (self._queued is None
                                       and not self._busy)
                              or self._error is not None)
            self._reraise()

    def close(self) -> None:
        """drain(), then stop the worker thread.  Idempotent."""
        with self._cv:
            if self._closed and not self._thread.is_alive():
                self._reraise()
                return
            self._cv.wait_for(lambda: (self._queued is None
                                       and not self._busy)
                              or self._error is not None)
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        self._reraise()

    def stats(self) -> dict:
        return {"submitted": self.submitted, "processed": self.processed,
                "dropped": self.dropped}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side -------------------------------------------------------

    def _reraise(self):
        if self._error is not None:
            err, self._error = self._error, None
            self._closed = True
            raise err

    def _loop(self):
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._queued is not None
                                  or self._closed)
                if self._queued is None:          # closed, queue empty
                    return
                step, snap, ready = self._queued
                self._queued = None
                self._busy = True
            try:
                for ev in ready:            # the clones are done
                    ev.synchronize()
                self._handler(step, self._stage(snap))
            except BaseException as e:            # surfaced at drain/close
                with self._cv:
                    self._error = e
                    self._busy = False
                    self._queued = None
                    self._cv.notify_all()
                return
            with self._cv:
                self.processed += 1
                self._busy = False
                self._cv.notify_all()
