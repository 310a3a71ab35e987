"""Synchronization-period schedules — the paper's core contribution (a copy
of `repro/core/schedules.py`; pure Python, no tensors).

GetH(s) for every strategy studied in the paper:

  qsr       H = max(H_base, floor((alpha/eta_t)^2))        (eq. 2 — ours)
  constant  H = H_base                                     (baseline ①)
  parallel  H = 1                                          (baseline ②)
  postlocal H = 1 until t0, then H_base                    (Lin et al. 2020, ③)
  inverse   H = max(H_base, floor(beta/eta_t))             (Gu et al. 2023, ④)
  cubic     H = max(H_base, floor((rho/eta_t)^3))          (App. G ablation)
  swap      H = H_base until t0, then local-until-end      (SWAP, App. H)

Related-work baselines (paper §A — optimization-perspective schedules):
  linear_inc  H grows linearly with the round index          (Haddadpour+ 19)
  dec_sqrt    H ~ H0/sqrt(1 + t/T)  (start infrequent, sync more as loss
              curvature grows)                               (Wang&Joshi 19)

Beyond the paper:
  adaptive  open-loop it is the QSR prior exactly; at run time
            `core/controller.py`'s AdaptiveController multiplies the prior
            by a divergence correction.  get_h here returns only the prior
            so the schedule stays a pure function of (run_cfg, t, lr) —
            every boundary rule below applies unchanged.

All schedules implement the paper's two boundary rules:
  * warmup: H is pinned to the value of the first post-warmup round (§2),
  * truncation: the last round is forced to end at T (H = T - t).
"""
from __future__ import annotations

import math
from typing import Callable, Iterator

LrFn = Callable[[int], float]

# The single source of truth for every H-schedule this repo implements.
# CLI `--schedule` choices, RunConfig docs, and tests all derive from this
# list so a new schedule can't be added in one place and forgotten elsewhere.
SCHEDULE_KINDS: tuple[str, ...] = (
    "qsr", "constant", "parallel", "postlocal", "inverse", "cubic", "swap",
    "linear_inc", "dec_sqrt", "adaptive",
)


def _eta_for_round(run_cfg, t: int, lr_fn: LrFn) -> float:
    # During warmup, use the lr right after warmup (paper §2, "Dealing with
    # Learning Rate Warmup").
    return lr_fn(max(t, run_cfg.warmup_steps))


def get_h(run_cfg, t: int, lr_fn: LrFn) -> int:
    """Synchronization period for the round starting at global step t."""
    total = run_cfg.total_steps
    kind = run_cfg.schedule
    eta = _eta_for_round(run_cfg, t, lr_fn)
    # The warmup pin (§2) applies to the *round*, not just eta: t-dependent
    # schedules (postlocal/swap/linear_inc/dec_sqrt) also see the first
    # post-warmup step while t < warmup_steps.  Truncation below still uses
    # the real t.
    tp = max(t, run_cfg.warmup_steps)
    if kind == "parallel":
        h = 1
    elif kind == "constant":
        h = run_cfg.h_base
    elif kind in ("qsr", "adaptive"):
        # "adaptive" shares the QSR prior; the closed-loop correction
        # never reaches this pure function
        h = max(run_cfg.h_base, int((run_cfg.alpha / eta) ** 2))
    elif kind == "inverse":
        h = max(run_cfg.h_base, int(run_cfg.beta / eta))
    elif kind == "cubic":
        h = max(run_cfg.h_base, int((run_cfg.rho / eta) ** 3))
    elif kind == "postlocal":
        h = 1 if tp < run_cfg.switch_frac * total else run_cfg.h_base
    elif kind == "swap":
        t0 = int(run_cfg.switch_frac * total)
        h = run_cfg.h_base if tp < t0 else (total - tp)
    elif kind == "linear_inc":
        # Haddadpour et al. 2019: H grows linearly as training proceeds
        h = run_cfg.h_base * (1 + int(4 * tp / max(total, 1)))
    elif kind == "dec_sqrt":
        # Wang & Joshi 2019: start with infrequent sync, decrease H
        h0 = 8 * run_cfg.h_base
        h = max(1, int(h0 / math.sqrt(1.0 + 8.0 * tp / max(total, 1))))
    else:
        raise ValueError(f"unknown schedule {kind!r}; known: {SCHEDULE_KINDS}")
    return max(1, min(h, total - t))  # truncate the final round (§2)


def rounds(run_cfg, lr_fn: LrFn) -> Iterator[tuple[int, int]]:
    """Yield (t_start, H) for every communication round of a run."""
    t = 0
    while t < run_cfg.total_steps:
        h = get_h(run_cfg, t, lr_fn)
        yield t, h
        t += h


def n_rounds(run_cfg, lr_fn: LrFn) -> int:
    return sum(1 for _ in rounds(run_cfg, lr_fn))


def comm_fraction(run_cfg, lr_fn: LrFn) -> float:
    """Communication volume relative to data-parallel (one all-reduce per
    step).  Matches the paper's "Comm." columns (Tables 1-3): each round costs
    one parameter all-reduce; parallel costs one gradient all-reduce per step."""
    return n_rounds(run_cfg, lr_fn) / run_cfg.total_steps


def h_trace(run_cfg, lr_fn: LrFn) -> list[tuple[int, int]]:
    return list(rounds(run_cfg, lr_fn))
