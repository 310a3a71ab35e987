"""Closed-loop adaptive controller: co-schedule H, the effective batch and
the overlap depth from the engine's telemetry (`--schedule adaptive`; a
copy of `repro/core/controller.py`, pure Python: the decisions are the
reference's, byte for byte, whenever both see the same telemetry).

QSR sets H from the learning rate alone, H = (alpha/eta)^2, but every round
the RoundEngine already measures the three quantities the rule's derivation
reasons about: the round loss, the worker-mean gradient norm, and the
pre-sync worker divergence `mean_i ||x_i - x_bar||`.  This module closes
the loop.  At each round *boundary* (decisions never move mid-round, the
same discipline as `membership_epoch`) the controller:

* **H**: starts from the QSR prior (`schedules.get_h`, kind "adaptive"
  returns exactly the quadratic rule, so warmup pinning and final-round
  truncation hold unchanged) and corrects it by the measured divergence.
  The SDE picture behind QSR says pre-sync divergence grows like
  `kappa * eta * sqrt(H)` for a noise level `kappa`.  Two EMAs of the
  measured kappa run at different time constants: a fast one (the signal)
  and a slow one seeded at the first post-warmup round (the trend the
  quadratic rule is currently calibrated to).  When the fast signal runs
  hotter than its trend H shrinks below quadratic; cooler, and H extends
  modestly beyond it:

      H = clip(prior * (kappa_ref / kappa_ema)^2,  prior/4,  prior*4)

  still floored at h_base and truncated at the horizon, like every kind.
  `int(prior * corr)` turns a divergence that differs in its last bits
  into an H one step apart, so two runs whose telemetry parts by sum-order
  noise may take different H: the port is held to the reference on the
  same telemetry (decisions) and on a replayed (h, lanes, depth) sequence
  (arithmetic), never on two free-running traces.

* **batch**: per Lau et al. 2024 (PAPERS.md), small per-worker batches
  early, growing as gradient noise starts to dominate.  The signal is the
  per-step loss improvement EMA: when it decays below `batch_growth_frac`
  of the best improvement seen, the per-worker batch doubles (a ratchet,
  never shrinking), up to the engine's allocated `b_loc`.  Batch changes
  ride `engine.batch_epoch()` (a round-boundary audit record); the engine
  then views each step's batch through `data/synthetic.py
  effective_batch_view`.

* **overlap depth**: chosen on the measured staleness/walltime frontier
  (a `{depth: s_per_round}` mapping, or a table4_walltime JSON's `overlap`
  rows).  Depth d runs the next round's first d steps on stale params; the
  controller allows d where the predicted extra drift `d * kappa_ema`
  stays within `stale_frac` of the round's own divergence budget, then
  takes the fastest allowed depth.  Only consulted when the engine runs
  `sync="overlap"`; depth moves at round boundaries through
  `engine.set_overlap_depth`.

`end_round` reads the round's three 0-d device tensors to the host with
`float()`: one device sync a round.  The controller keeps no state in a
checkpoint, as the reference keeps none: a resumed adaptive run
recalibrates, and its first `begin_round` sets the lanes to `b_loc / 2`.

Every decision is appended to an in-memory trace and can be persisted as
`controller_trace.json` (schema "controller_trace/v1").
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable

from repro_torch.core import schedules

TRACE_SCHEMA = "controller_trace/v1"


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knob bounds and feedback gains.  Defaults are deliberately gentle:
    the controller should refine QSR, not fight it."""
    # H correction: clip of (kappa_ref / kappa_ema)^2 applied to the prior
    h_correction_bounds: tuple[float, float] = (0.25, 4.0)
    # EMA weights for the divergence-rate signal kappa = div / (eta sqrt(H)):
    # the fast EMA is the signal, the slow one the reference trend the H
    # correction compares it against
    kappa_ema: float = 0.5
    kappa_ema_slow: float = 0.15
    # batch: start at b_loc / batch_start_div (largest pow2 divisor <= it),
    # double when the improvement EMA falls below batch_growth_frac * best
    batch_start_div: int = 2
    batch_growth_frac: float = 0.35
    imp_ema: float = 0.5
    # overlap depth: allowed when d * kappa_ema * eta <= stale_frac * the
    # round's own predicted divergence kappa_ref * eta * sqrt(h)
    stale_frac: float = 0.5
    depth_choices: tuple[int, ...] = (0, 1, 2)


def _pow2_divisor_at_most(b: int, target: int) -> int:
    """Largest divisor of b that is a power of two and <= target (>= 1)."""
    d = 1
    while d * 2 <= target and b % (d * 2) == 0:
        d *= 2
    return d


class AdaptiveController:
    """One instance per run.  Drive it as a pair around each round:

        h = ctrl.begin_round(t)          # decide + apply knobs to engine
        state, m = eng.run_round(state, t, h, lr_fn)
        ctrl.end_round(t, h, m)          # feed back measured telemetry

    `engine` is optional: without one the controller still produces the H
    stream (pure decisions, unit-testable); with one it also drives the
    batch knob (`engine.batch_epoch`, engines built with
    `adaptive_batch=True`) and — under sync="overlap" with a `frontier` —
    the overlap depth (`engine.set_overlap_depth`).
    """

    def __init__(self, run_cfg, lr_fn: Callable[[int], float], *,
                 engine=None, cfg: ControllerConfig | None = None,
                 frontier: dict[int, float] | None = None):
        if run_cfg.schedule != "adaptive":
            raise ValueError(
                f"AdaptiveController drives schedule='adaptive', run_cfg "
                f"has {run_cfg.schedule!r}")
        self.run_cfg, self.lr_fn = run_cfg, lr_fn
        self.cfg = cfg or ControllerConfig()
        self.engine = engine
        # {depth: s_per_round} — the measured walltime frontier
        # (benchmarks/table4_walltime.py); depths outside depth_choices are
        # ignored, depth 0 is always a candidate
        self.frontier = ({int(k): float(v) for k, v in frontier.items()
                          if int(k) in self.cfg.depth_choices}
                         if frontier else None)
        self._adaptive_batch = bool(engine is not None
                                    and getattr(engine, "adaptive_batch",
                                                False))
        self._adaptive_depth = bool(
            engine is not None and self.frontier
            and getattr(engine, "sync_mode", "blocking") == "overlap")
        b_loc = getattr(engine, "b_loc", 1) if engine is not None else 1
        self.batch_lanes = (_pow2_divisor_at_most(
            b_loc, max(1, b_loc // self.cfg.batch_start_div))
            if self._adaptive_batch else b_loc)
        self.b_loc = b_loc
        # feedback state
        self.kappa_ref: float | None = None     # slow EMA (the trend)
        self.kappa: float | None = None         # fast EMA of div/(eta sqrt h)
        self.imp: float | None = None           # EMA per-step loss drop
        self.best_imp: float = 0.0
        self.last_loss: float | None = None
        self.overlap_depth = (getattr(engine, "overlap_depth", 0)
                              if engine is not None else 0)
        self.trace: list[dict] = []
        self._open: dict | None = None          # row awaiting end_round

    # -- decision ---------------------------------------------------------

    def _eta(self, t: int) -> float:
        return float(self.lr_fn(max(t, self.run_cfg.warmup_steps)))

    def _decide_h(self, t: int) -> tuple[int, int, float, list[str]]:
        prior = schedules.get_h(self.run_cfg, t, self.lr_fn)
        reasons = []
        corr = 1.0
        if t < self.run_cfg.warmup_steps:
            # §2 warmup pin: the prior is already pinned; telemetry from
            # warmup rounds is not trusted to steer H
            reasons.append("warmup-pin")
        elif self.kappa_ref is None or not self.kappa:
            reasons.append("calibrating")
        else:
            lo, hi = self.cfg.h_correction_bounds
            corr = min(max((self.kappa_ref / self.kappa) ** 2, lo), hi)
            reasons.append("div-corrected")
        h = max(self.run_cfg.h_base, int(prior * corr))
        h = max(1, min(h, self.run_cfg.total_steps - t))   # truncation (§2)
        return h, prior, corr, reasons

    def _decide_batch(self, t: int, reasons: list[str]) -> int:
        if not self._adaptive_batch:
            return self.batch_lanes
        if (t >= self.run_cfg.warmup_steps and self.imp is not None
                and self.best_imp > 0.0
                and self.imp < self.cfg.batch_growth_frac * self.best_imp
                and self.batch_lanes < self.b_loc):
            self.batch_lanes = min(self.b_loc, self.batch_lanes * 2)
            # ratchet: the grown batch gets a fresh improvement baseline
            self.best_imp = self.imp if self.imp > 0.0 else 0.0
            reasons.append("batch-grow")
        return self.batch_lanes

    def _decide_depth(self, t: int, h: int, reasons: list[str]) -> int:
        if not self._adaptive_depth:
            return self.overlap_depth
        eta = self._eta(t)
        kap = self.kappa if self.kappa else None
        ref = self.kappa_ref if self.kappa_ref else kap
        allowed = {0}
        if kap is not None and ref is not None and kap > 0.0 and eta > 0.0:
            budget = self.cfg.stale_frac * ref * math.sqrt(max(h, 1))
            allowed |= {d for d in self.frontier
                        if d > 0 and d * kap <= budget}
        else:
            reasons.append("depth-hold-calibrating")
        cost = lambda d: self.frontier.get(
            d, 0.0 if d == 0 else float("inf"))
        best = min(sorted(allowed), key=cost)
        if best != self.overlap_depth:
            reasons.append(f"depth->{best}")
            self.overlap_depth = best
        return self.overlap_depth

    def begin_round(self, t: int) -> int:
        """Decide (H, batch lanes, overlap depth) for the round starting at
        step t, apply the batch/depth knobs to the attached engine, and
        return H.  Must alternate with end_round — decisions are round-
        boundary-only by construction."""
        if self._open is not None:
            raise RuntimeError(
                "begin_round called twice without end_round: controller "
                "decisions are round-boundary-only")
        h, prior, corr, reasons = self._decide_h(t)
        lanes = self._decide_batch(t, reasons)
        depth = self._decide_depth(t, h, reasons)
        if self.engine is not None:
            if self._adaptive_batch and self.engine.batch_lanes != lanes:
                self.engine.batch_epoch(lanes)
            if self._adaptive_depth and self.engine.overlap_depth != depth:
                self.engine.set_overlap_depth(depth)
        self._open = {
            "t": int(t), "h": int(h), "h_prior": int(prior),
            "h_correction": round(float(corr), 6),
            "batch_lanes": int(lanes),
            "batch_frac": round(lanes / max(self.b_loc, 1), 6),
            "overlap_depth": int(depth),
            "lr": round(self._eta(t), 8),
            "signals": {
                "kappa_ema": None if self.kappa is None
                else round(self.kappa, 8),
                "kappa_ref": None if self.kappa_ref is None
                else round(self.kappa_ref, 8),
                "imp_ema": None if self.imp is None else round(self.imp, 8),
            },
            "reasons": reasons,
        }
        return h

    # -- feedback ---------------------------------------------------------

    def end_round(self, t: int, h: int, metrics: dict[str, Any]) -> None:
        """Feed back the executed round's telemetry (the engine's metrics
        dict — device scalars or floats for "loss", "grad_norm",
        "divergence")."""
        if self._open is None or self._open["t"] != int(t):
            raise RuntimeError(
                f"end_round({t}) without a matching begin_round "
                f"(open: {None if self._open is None else self._open['t']})")
        loss = float(metrics["loss"])
        div = float(metrics["divergence"])
        gn = float(metrics.get("grad_norm", 0.0))
        eta = self._eta(t)
        # drift intensity: div ~ kappa * eta * sqrt(h)  (the SDE scaling)
        kap = div / max(eta * math.sqrt(max(h, 1)), 1e-12)
        a = self.cfg.kappa_ema
        self.kappa = kap if self.kappa is None else a * kap + (1 - a) * self.kappa
        if self.kappa_ref is not None:
            s = self.cfg.kappa_ema_slow
            self.kappa_ref = s * kap + (1 - s) * self.kappa_ref
        elif t + h > self.run_cfg.warmup_steps:
            self.kappa_ref = self.kappa        # seed the trend post-warmup
        if self.last_loss is not None:
            imp = (self.last_loss - loss) / max(h, 1)
            b = self.cfg.imp_ema
            self.imp = imp if self.imp is None else b * imp + (1 - b) * self.imp
            if t >= self.run_cfg.warmup_steps and self.imp > self.best_imp:
                self.best_imp = self.imp
        self.last_loss = loss
        row = self._open
        self._open = None
        row["measured"] = {"loss": loss, "grad_norm": gn, "divergence": div,
                           "kappa": round(kap, 8)}
        self.trace.append(row)

    # -- trace ------------------------------------------------------------

    def trace_record(self) -> dict:
        """The serializable run record (schema controller_trace/v1)."""
        hs = [r["h"] for r in self.trace]
        return {
            "schema": TRACE_SCHEMA,
            "schedule": self.run_cfg.schedule,
            "config": dataclasses.asdict(self.cfg),
            "b_loc": self.b_loc,
            "adaptive_batch": self._adaptive_batch,
            "adaptive_depth": self._adaptive_depth,
            "frontier": self.frontier,
            "rounds": self.trace,
            "summary": {
                "n_rounds": len(self.trace),
                "steps": int(sum(hs)),
                "h_min": int(min(hs)) if hs else None,
                "h_max": int(max(hs)) if hs else None,
                "final_batch_lanes": int(self.batch_lanes),
                "final_overlap_depth": int(self.overlap_depth),
                "comm_fraction": (len(self.trace) / sum(hs)) if hs else None,
            },
        }

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.trace_record(), f, indent=1)


def load_frontier(path_or_recs) -> dict[int, float] | None:
    """Parse a {depth: s_per_round} frontier from a table4_walltime JSON
    artifact (its `overlap` section tags rows `blocking_d0`, `overlap_d1`,
    ...) or pass through an already-shaped {depth: s} mapping."""
    recs = path_or_recs
    if isinstance(path_or_recs, str):
        try:
            with open(path_or_recs) as f:
                recs = json.load(f)
        except (OSError, ValueError):
            return None
    if not isinstance(recs, dict):
        return None
    if "overlap" in recs and isinstance(recs["overlap"], dict):
        out = {}
        for tag, row in recs["overlap"].items():
            if tag.endswith("_ring") or "_d" not in tag:
                continue
            try:
                out[int(tag.rsplit("_d", 1)[1])] = float(row["s_per_round"])
            except (KeyError, TypeError, ValueError):
                continue
        return out or None
    try:
        return {int(k): float(v) for k, v in recs.items()} or None
    except (TypeError, ValueError):
        return None
