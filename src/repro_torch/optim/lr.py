"""Learning-rate schedules from the paper (§4.1, App. C): cosine, linear and
step decay, each with linear warmup.  Step decay is the paper's construction:
eta_step(t) = 2^round(log2(eta_cos(t))).  A copy of `repro/optim/lr.py`."""
from __future__ import annotations

import math


def cosine(t: int, *, peak: float, end: float, warmup: int, total: int) -> float:
    if warmup and t < warmup:
        return peak * (t + 1) / warmup
    frac = min(max(t - warmup, 0) / max(total - warmup, 1), 1.0)
    return end + 0.5 * (peak - end) * (1 + math.cos(math.pi * frac))


def linear(t: int, *, peak: float, end: float, warmup: int, total: int) -> float:
    if warmup and t < warmup:
        return peak * (t + 1) / warmup
    frac = min(max(t - warmup, 0) / max(total - warmup, 1), 1.0)
    return peak + frac * (end - peak)


def step(t: int, *, peak: float, end: float, warmup: int, total: int) -> float:
    """Paper App. C: cosine rounded to powers of two."""
    eta = cosine(t, peak=peak, end=end, warmup=warmup, total=total)
    if eta <= 0:
        return end
    return 2.0 ** round(math.log2(eta))


SCHEDULES = {"cosine": cosine, "linear": linear, "step": step}


def make_lr_fn(run_cfg):
    fn = SCHEDULES[run_cfg.lr_schedule]

    def lr(t: int) -> float:
        return fn(t, peak=run_cfg.peak_lr, end=run_cfg.end_lr,
                  warmup=run_cfg.warmup_steps, total=run_cfg.total_steps)

    return lr
