"""Optimizers, built from scratch (port of `repro/optim/optimizers.py`):
SGD+momentum and AdamW.

The AdamW update is the innermost loop of every local step, so it routes
through `repro_torch.kernels.ops.adamw_update`: the fused CUDA kernel on the
card (updating p, m, v in place), the plain version on the CPU.  Optimizer
state is a tree mirroring params; a leading worker axis rides along
(updates are elementwise), and under the flat layout `params` is a dict of
dtype buckets `[W, N]`, so the optimizer is one kernel launch per bucket
instead of one per leaf, with bitwise the same per-element results.

`step` is a 0-d int32 CPU tensor (the reference keeps it on the device):
the kernel takes it as a runtime scalar, and reading it costs no device
synchronisation.  Call `update` under `torch.no_grad()`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.kernels import ops as kops

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Any      # params -> opt_state
    update: Any    # (params, opt_state, grads, lr) -> (params, opt_state)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _pick(out: Tree, i: int) -> Tree:
    return T.map(lambda t: t[i], out)


def sgd(momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": T.map(_zeros_f32, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(params, state, grads, lr, grad_norm=None):
        del grad_norm                   # sgd has no clip
        def one(p, m, g):
            gf = g.float() + weight_decay * p.float()
            m1 = momentum * m + gf
            d = gf + momentum * m1 if nesterov else m1
            return (p.float() - lr * d).to(p.dtype), m1

        out = T.map(one, params, state["mu"], grads)
        return _pick(out, 0), {"mu": _pick(out, 1), "step": state["step"] + 1}

    return Optimizer(init, update)


def adamw(beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.05, clip_norm: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": T.map(_zeros_f32, params), "v": T.map(_zeros_f32, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def update(params, state, grads, lr, grad_norm=None):
        """`grad_norm`, when given, is the whole gradient's norm for the
        clip (a mesh rank's `grads` are its chunk of it)."""
        if clip_norm > 0:
            gn = global_norm(grads) if grad_norm is None else grad_norm
            scale = torch.clamp(clip_norm / (gn + 1e-9), max=1.0)
            grads = T.map(lambda g: g * scale.to(g.dtype), grads)
        step = state["step"] + 1
        stepf = step.float()

        def one(p, m, v, g):
            return kops.adamw_update(p, m, v, g, lr=lr, beta1=beta1,
                                     beta2=beta2, eps=eps,
                                     weight_decay=weight_decay, step=stepf)

        out = T.map(one, params, state["m"], state["v"], grads)
        return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                               "step": step}

    return Optimizer(init, update)


def global_norm(tree: Tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree))
    return torch.sqrt(sq)


def make_optimizer(run_cfg) -> Optimizer:
    if run_cfg.optimizer == "sgd":
        return sgd(momentum=0.9, weight_decay=run_cfg.weight_decay)
    return adamw(weight_decay=run_cfg.weight_decay)
