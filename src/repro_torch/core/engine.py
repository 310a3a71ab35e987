"""RoundEngine: the runtime that owns state, data and telemetry for a
training run (port of `repro/core/engine.py`, blocking sync).

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

Layouts: "tree" (state mirrors the model tree) and "flat" (one `[W, N]`
buffer per dtype bucket: one optimizer kernel launch per step and one sync
kernel launch per round per bucket; bitwise the tree trajectory).  Data:
"host" with a `batch_fn(step) -> batch [W, B_loc, ...]` (CPU tensors, moved
to the run's device here); `data_seconds` accumulates the host time spent
in `batch_fn`.  Anything else of the reference — device data, the built-in
token stream, flat_sharded, overlap/partial sync, meshes, adaptive batch,
membership changes, checkpoints — raises `ConfigError("not ported yet")`.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch import tree as T
from repro_torch.core import flat
from repro_torch.core import local_update as LU
from repro_torch.core.sync import make_sync
from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError
from repro_torch.models import api, param as pm

Tree = Any


def worker_divergence(params: Tree) -> torch.Tensor:
    """mean_i ||x_i - x_bar||_2 over the leading worker axis, all leaves."""
    sq = 0.0
    for x in T.leaves(params):
        xf = x.float()
        m = torch.mean(xf, 0, keepdim=True)
        sq = sq + torch.sum(torch.square(xf - m), dim=tuple(range(1, xf.ndim)))
    return torch.mean(torch.sqrt(sq))


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
                 overlap_depth: int = 0, mesh=None,
                 batch_fn: Callable | None = None,
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
        for bad, what in ((data == "device", "data='device'"),
                          (batch_fn is None, "the built-in token stream"),
                          (layout == "flat_sharded", "layout='flat_sharded'"),
                          (sync != "blocking", f"sync={sync!r}"),
                          (mesh is not None, "a mesh"),
                          (adaptive_batch, "adaptive_batch")):
            if bad:
                raise ConfigError(f"{what}: not ported yet")
        self.device = resolve_device(device)
        self.cfg, self.run_cfg = cfg, run_cfg
        self.workers, self.b_loc, self.seq, self.seed = workers, b_loc, seq, seed
        self.mode, self.data, self.layout = mode, data, layout
        self.sync_mode, self.overlap_depth = sync, overlap_depth
        self._host_batch = batch_fn
        self.spec = None                    # FlatParamSpace (layout="flat")
        self._step = self._sync = None
        self.h_trace: list[tuple[int, int]] = []    # (t_start, h) executed
        self.round_metrics: list[dict] = []         # per round, device scalars
        self.data_seconds = 0.0                     # host time in batch_fn

    # -- state ------------------------------------------------------------

    def _ensure_spec(self, params_single: Tree | None = None):
        if self.spec is None:
            if params_single is None:
                mod = api.get_module(self.cfg)
                params_single = pm.abstract_params(mod.param_defs(self.cfg))
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
        state = LU.init_state(self.cfg, self.run_cfg, params_single,
                              self.workers)
        if self.layout == "flat":
            state = flat.to_flat_state(self._ensure_spec(params_single), state)
        return state

    def params_single(self, state: Tree) -> Tree:
        """Worker-0 params as the model tree, whatever the layout (views)."""
        params = state["params"]
        if self.layout == "flat":
            params = self._ensure_spec().unflatten(params, lead=1)
        return T.map(lambda x: x[0], params)

    # -- execution --------------------------------------------------------

    def _programs(self):
        if self._step is None:
            spec = self._ensure_spec() if self.layout == "flat" else None
            self._step = LU.make_local_step(self.cfg, self.run_cfg,
                                            with_metrics=True, spec=spec)
            self._sync = make_sync(self.run_cfg, spec=spec)
        return self._step, self._sync

    def run_round(self, state: Tree, t: int, h: int, lr_fn):
        """Execute the communication round starting at step t with period h:
        h local steps on batches `batch_fn(t + i)`, then the sync.  Returns
        (state, metrics) with metrics {"loss", "grad_norm", "divergence"} as
        0-d device tensors."""
        step, sync = self._programs()
        losses, gns = [], []
        for i in range(h):
            t0 = time.perf_counter()
            batch = self._host_batch(t + i)
            self.data_seconds += time.perf_counter() - t0
            batch = T.map(lambda x: x.to(self.device), batch)
            state, (loss, gn) = step(state, batch, lr_fn(t + i))
            losses.append(loss)
            gns.append(gn)
        with torch.no_grad():
            metrics = _metrics(state["params"], losses, gns, float(h))
            state = sync(state)
        self.h_trace.append((t, h))
        self.round_metrics.append(metrics)
        return state, metrics

    def synced_view(self, state: Tree) -> Tree:
        """The synced consensus: under blocking sync, the state itself."""
        return state

    def flush(self, state: Tree) -> Tree:
        """Apply the in-flight sync: under blocking sync there is none."""
        return state
