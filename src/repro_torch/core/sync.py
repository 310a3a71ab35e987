"""Synchronization (model averaging) applied every H steps (port of
`repro/core/sync.py`, the blocking, collective-free part).

Paper-faithful sync (Alg. 2 line 15): the global iterate is the plain mean
of the worker replicas; optimizer state is not averaged.  Beyond the paper:
outer Nesterov momentum on the sync delta and int8-quantized deltas, both
carrying an `anchor` (the params at the previous sync).  Quantized, the
mean runs over the integer codes q = clip(round(d/s*127)) and is
dequantized once after it (the reference's RS-domain rule), so it is exact
in any summation order.

Layouts:
  * tree (spec=None) — the composed path: `make_sync_begin` (delta, scales,
    code mean) then `make_sync_apply` (the plain `sync_apply_update` per
    leaf and the broadcast back to the W lanes), as the reference composes
    them for its tree layout.
  * flat (spec=FlatParamSpace) — one fused pass per dtype bucket through
    `ops.sync_flat_update` (the CUDA kernel on the card) whenever an anchor
    is in play; plain `worker_mean` otherwise.
Both run the same elementwise ops, so the layouts stay bitwise equal.
Partial, overlap and ring-int8 sync, and the collectives of the sharded
layout, are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def worker_mean(tree):
    """Mean over the leading worker axis, broadcast back to every lane (new
    tensors)."""
    def one(x):
        m = kref.mean0(x.float())
        return m[None].expand(x.shape).to(x.dtype).contiguous()
    return T.map(one, tree)


def _guarded_scale(amax: torch.Tensor) -> torch.Tensor:
    """int8 scale from a max-|delta| statistic; an all-zero delta keeps
    scale 1 so its round trip is exactly zero."""
    return torch.where(amax > 0.0, amax, torch.ones_like(amax))


def flat_delta_scales(spec, bucket: str, p, anchor):
    """Per-tensor int8 scales for one flat bucket, spread to elements [N]:
    max|p - anchor| over the worker axis and every element of each leaf —
    the tree path's per-leaf statistic, bitwise (max is exact)."""
    d = p.float() - anchor.float()[None]
    d = torch.amax(d.abs_(), 0)
    return spec.spread(bucket, _guarded_scale(spec.segment_max(bucket, d)))


def _check_wire(run_cfg) -> None:
    if run_cfg.sync_wire != "auto":
        raise ConfigError(f"sync_wire={run_cfg.sync_wire!r}: not ported yet")


def _tree_only(spec) -> None:
    if spec is not None:
        raise ConfigError("the composed flat sync (overlap / sharded "
                          "layouts): not ported yet")


def make_sync_begin(run_cfg, spec=None):
    """First half of the sync, tree layout: begin(state) -> pending — the
    worker-mean params (plain), the worker-mean delta (momentum only), or
    {"q": mean codes, "scale": per-leaf scales} (quantized)."""
    _check_wire(run_cfg)
    _tree_only(spec)
    quantize, mom = run_cfg.sync_quantize, run_cfg.outer_momentum

    def begin(state):
        params = state["params"]
        if not quantize and mom == 0.0:
            return T.map(lambda p: kref.mean0(p.float()), params)
        delta = T.map(lambda p, a: p.float() - a.float()[None], params,
                      state["anchor"])
        if quantize:
            scales = T.map(lambda d: _guarded_scale(torch.max(torch.abs(d))),
                           delta)
            qmean = T.map(lambda d, s: kref.mean0(kref.quantize_codes(d, s)),
                          delta, scales)
            return {"q": qmean, "scale": scales}
        return T.map(kref.mean0, delta)

    return begin


def make_sync_apply(run_cfg, spec=None):
    """Second half, tree layout: apply(state, pending) -> state with the
    outer update applied and the consensus broadcast to every lane."""
    _check_wire(run_cfg)
    _tree_only(spec)
    quantize, mom = run_cfg.sync_quantize, run_cfg.outer_momentum

    def to_params(consensus, params):
        return T.map(lambda c, p: c[None].expand(p.shape).to(p.dtype)
                     .contiguous(), consensus, params)

    def apply(state, pending):
        params = state["params"]
        if not quantize and mom == 0.0:
            return {**state, "params": to_params(pending, params)}
        step_in = pending["q"] if quantize else pending
        ls, treedef = T.flatten(step_in)
        la = T.leaves(state["anchor"])
        lsc = T.leaves(pending["scale"]) if quantize else [None] * len(ls)
        lmu = T.leaves(state["outer_mu"]) if mom > 0.0 else [None] * len(ls)
        outs = [kref.sync_apply_update(s, a, scale=sc, mu=m, momentum=mom)
                for s, a, sc, m in zip(ls, la, lsc, lmu)]
        new_state = dict(state)
        new_state["anchor"] = T.unflatten(treedef, [o[0] for o in outs])
        if mom > 0.0:
            new_state["outer_mu"] = T.unflatten(treedef, [o[1] for o in outs])
        new_state["params"] = to_params(new_state["anchor"], params)
        return new_state

    return apply


def make_sync(run_cfg, spec=None):
    """Returns sync(state) -> state.  state = {"params", "opt", "anchor"?,
    "outer_mu"?}; params carry a leading worker axis.  With `spec` (a
    FlatParamSpace) the state is flat: params {bucket: [W, N]},
    anchor/outer_mu {bucket: [N]}, and an anchored sync is one fused
    `sync_flat_update` per bucket (in place on the card)."""
    _check_wire(run_cfg)
    quantize, mom = run_cfg.sync_quantize, run_cfg.outer_momentum

    if spec is not None:
        def sync_flat(state):
            params = state["params"]
            if not quantize and mom == 0.0:
                return {**state, "params": worker_mean(params)}
            new_state = dict(state)
            new_p, new_a = {}, {}
            new_mu = {} if mom > 0.0 else None
            for b in spec.buckets:
                p, a = params[b], state["anchor"][b]
                scale = flat_delta_scales(spec, b, p, a) if quantize else None
                mu = state["outer_mu"][b] if mom > 0.0 else None
                new_p[b], new_a[b], mu2 = kops.sync_flat_update(
                    p, a, scale=scale, mu=mu, momentum=mom)
                if mom > 0.0:
                    new_mu[b] = mu2
            new_state["params"], new_state["anchor"] = new_p, new_a
            if mom > 0.0:
                new_state["outer_mu"] = new_mu
            return new_state

        return sync_flat

    begin = make_sync_begin(run_cfg)
    apply_ = make_sync_apply(run_cfg)

    def sync_composed(state):
        return apply_(state, begin(state))

    return sync_composed
