"""Synchronization (model averaging) applied every H steps (port of
`repro/core/sync.py`, its mesh-less half).

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
  * flat (spec=FlatParamSpace) — the blocking sync is one fused pass per
    dtype bucket through `ops.sync_flat_update` (the CUDA kernel on the
    card, in place) whenever an anchor is in play; plain `worker_mean`
    otherwise.  The split halves (overlap, partial, ring) apply through
    `ops.sync_apply_update`, one launch per bucket, out of place.
Both run the same elementwise ops, so the layouts stay bitwise equal.

The split sync: `make_sync_begin` (the reduce: a pure function of the
pre-sync state) and `make_sync_apply` (dequantize, outer update, params),
which the engine's overlap mode runs one round apart.  Pending syncs are the
mean params (plain), the mean delta (momentum only) or {"q", "scale"}
(quantized); `entry_params` turns the apply into the correction form
x_i <- x_i + (consensus - entry_i) for overlap depth > 0.

Partial participation (`make_sync_partial`): a membership mask m in {0,1}^W
zeroes absent lanes' deltas BEFORE the scale statistic and the quantizer;
the mean divides by |P| = sum(m).  Quantized pendings carry the undivided
code sum and {"count": |P|}.  The apply broadcasts the consensus to ALL W
lanes, so an absent lane re-anchors.

The ring-int8 wire (`run_cfg.sync_wire`): the re-quantizing ring, emulated
mesh-less over one bucket (`ring_codes_host`): per ring chunk, W - 1 hops
of `ops.ring_combine` + `ops.ring_quantize_codes` carrying int8 codes and a
0-d device scale.  Its result is within `ring_tolerance` of the exact mean,
never bitwise.

The collective halves (spec = a ShardedFlatSpace carrying a mesh,
`launch/mesh.py`): each process is one rank, holding its worker's chunk
`[1, N/S]` of the params and its chunk `[N/S]` of the anchor
(`core/flat.py flat_state_slices`).  The worker mean splits into a
reduce-scatter over the worker group (rank (i, s) then owns sub-chunk i of
shard s's mean, `[1, N/(W S)]`) and an all-gather back to `[N/S]`, which
the apply runs.  Quantized: shard-local partial amaxes per tensor, one MAX
over the world group, int8 codes, then the code sums reduce-scattered at
`wire_dtype(W)` (int16 while W * 127 < 2^15: a ring of int8 views, as the
mesh module carries int16) and gathered back the same way; the sums are
exact in any order, so every rank's chunk is bitwise the mesh-less path's.
The ring wire runs W - 1 `ring_shift` hops of int8 codes and a scalar
scale, folded by the `ring_combine` / `ring_quantize_codes` kernels.  The
pending of an overlap sync stays on each rank: Σq of its sub-chunk and the
scales of its shard chunk (quantized), its int8 mean sub-chunk and one
scale (ring), or its f32 mean sub-chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.errors import ConfigError, LayoutError
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


def _lane_mask(mask, x):
    """A [W] mask shaped to multiply `x` [W, ...] lane by lane."""
    return mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


def flat_delta_scales(spec, bucket: str, p, anchor, mask=None):
    """Per-tensor int8 scales for one flat bucket, spread to elements [N]:
    max|p - anchor| over the worker axis and every element of each leaf —
    the tree path's per-leaf statistic, bitwise (max is exact).  A
    membership `mask` ([W] f32) zeroes absent lanes' deltas first, so the
    statistic is exactly the participant amax."""
    d = (p.float() - anchor.float()[None]).abs_()
    if mask is not None:
        d = d * _lane_mask(mask, d)
    d = torch.amax(d, 0)
    return spec.spread(bucket, _guarded_scale(spec.segment_max(bucket, d)))


def wire_dtype(w: int) -> torch.dtype:
    """Smallest integer dtype that holds the on-wire sum of W int8 codes
    exactly: the reduce-scatter's payload type of the quantized collective
    sync (the ring's hops carry int8: one re-quantized mean each)."""
    if w <= 1:
        return torch.int8
    return torch.int16 if w * 127 < 2 ** 15 else torch.int32


# --------------------------------------------------------------------------
# The collective halves: reduce-scatter | all-gather over a mesh
# --------------------------------------------------------------------------

def _use_collectives(spec) -> bool:
    """True when `spec` is a mesh-carrying ShardedFlatSpace with worker
    axes: the explicit reduce-scatter / all-gather decomposition."""
    return (getattr(spec, "mesh", None) is not None
            and bool(getattr(spec, "worker_axes", ())))


def _groups(spec):
    """The mesh's groups for the spec's worker axes; a rank's worker index
    among them is the reference's `_linear_worker_index` (row-major over
    the worker axes)."""
    return spec.mesh.groups(spec.worker_axes)


def _chunk_lo(spec, groups, bucket: str) -> int:
    """Offset of this rank's shard chunk in the bucket buffer."""
    return groups.shard_index * (spec.buffer_size(bucket) // groups.n_shards)


def _lane(mask, groups):
    """This rank's worker's entry of a [W] membership mask, as a 0-d
    tensor on the mask's device."""
    return mask[groups.worker_index]


def partial_segment_amax(spec, bucket: str, d, lo: int):
    """Shard-local per-tensor partial amax of one bucket chunk: d [W_loc,
    n] delta rows of the elements [lo, lo + n) -> [#leaves] f32, -inf (the
    max identity) for a tensor the chunk holds none of; a MAX over every
    chunk's partials is the whole tensor's amax, exactly."""
    return spec.chunk_segment_max(bucket, torch.amax(d.abs(), 0), lo)


def _rs_mean(spec, x, w: int, mask=None):
    """[1, n] f32 chunk -> this rank's [1, n/W] sub-chunk of the worker
    mean, by one reduce-scatter over the worker group.  With a membership
    mask the mean runs over the participants: absent lanes are zeroed
    before the reduce and the divisor is |P|, the SUM of the lanes' entries
    over the worker group."""
    g = _groups(spec)
    mesh = spec.mesh
    if mask is None:
        return kref.true_div(mesh.reduce_scatter_sum(x[0], g.worker),
                             float(w))[None]
    m = _lane(mask, g)
    cnt = mesh.all_reduce(m.reshape(1), "sum", g.worker)[0]
    return (mesh.reduce_scatter_sum(x[0] * m, g.worker) / cnt)[None]


def _ag_mean(spec, pending):
    """Inverse leg: this rank's [1, n/W] sub-chunk -> its shard's whole
    consensus chunk [n], by one all-gather over the worker group."""
    g = _groups(spec)
    return spec.mesh.all_gather(pending[0], g.worker)


def _rs_quantized_begin(spec, params, anchor, mask=None):
    """The quantized reduce on a rank: the delta of its chunk, per-tensor
    partial amaxes of the chunk (-inf for a tensor it holds none of), one
    MAX over the world group (a [sum #leaves] fold, the only scale
    collective), int8 codes, then one reduce-scatter per bucket of the codes
    at `wire_dtype(W)`.  Returns {"q": {bucket: [1, n/W] code sums},
    "scale": {bucket: [n] f32}} (+ {"count": |P|} with a mask, whose absent
    lanes' deltas are zeroed before the amax and the quantizer)."""
    g = _groups(spec)
    mesh = spec.mesh
    w = g.n_workers
    wdt = wire_dtype(w)
    m = None if mask is None else _lane(mask, g)
    d, parts = {}, []
    for b in spec.buckets:
        d[b] = params[b].float() - anchor[b].float()[None]
        if m is not None:
            d[b] = d[b] * m
        parts.append(partial_segment_amax(spec, b, d[b],
                                          _chunk_lo(spec, g, b)))
    full = mesh.all_reduce(torch.cat(parts), "max", g.world)
    out = {"q": {}, "scale": {}}
    off = 0
    for b in spec.buckets:
        n_leaves = spec.bucket_leaves(b)
        per_leaf = _guarded_scale(full[off:off + n_leaves])
        off += n_leaves
        lo = _chunk_lo(spec, g, b)
        scale = spec.chunk_spread(b, per_leaf, lo, lo + d[b].shape[1])
        codes = kref.quantize_codes(d[b], scale[None]).to(wdt)
        out["q"][b] = mesh.reduce_scatter_sum(codes[0], g.worker)[None]
        out["scale"][b] = scale
    if mask is not None:
        out["count"] = mask.sum()
    return out


def _ag_codes(spec, qs):
    """Gather leg of the quantized sync: each rank's [1, n/W] code sums ->
    its shard chunk's [n], in the wire dtype."""
    g = _groups(spec)
    return {b: spec.mesh.all_gather(q[0], g.worker) for b, q in qs.items()}


def _ring_quantized_begin(spec, params, anchor):
    """The int8 ring reduce on a rank: its chunk's delta splits into W
    sub-chunks; worker i seeds the partial of sub-chunk (i - 1) mod W, and
    W - 1 `ring_shift` hops each carry one int8-quantized partial MEAN and
    its f32 scalar scale, folded with the local sub-chunk by `ring_combine`
    and re-quantized by `ring_quantize_codes`.  After the last hop worker i
    owns the mean of sub-chunk i.  Returns {"q": {bucket: [1, n/W] int8},
    "scale": {bucket: [1, 1] f32}}: the codes ARE the mean, one scale a
    rank."""
    g = _groups(spec)
    mesh = spec.mesh
    w, i = g.n_workers, g.worker_index
    qs, ss = {}, {}
    for b in spec.buckets:
        d = params[b].float() - anchor[b].float()[None]
        n_loc = d.shape[1]
        if n_loc % w:
            raise LayoutError(
                f"ring bucket {b!r}: shard length {n_loc} not divisible "
                f"by {w} workers")
        dc = d[0].reshape(w, n_loc // w)
        acc = dc[(i - 1) % w]
        s = _guarded_scale(torch.max(torch.abs(acc)))
        q = kops.ring_quantize_codes(acc, s)
        for k in range(1, w):
            q = mesh.ring_shift(q, g.worker)
            s = mesh.ring_shift(s.reshape(1), g.worker)[0]
            acc, amax = kops.ring_combine(q, s, dc[(i - 1 - k) % w], k)
            s = _guarded_scale(amax)
            q = kops.ring_quantize_codes(acc, s)
        qs[b] = q[None]
        ss[b] = s.reshape(1, 1)
    return {"q": qs, "scale": ss}


def _ag_ring(spec, pending):
    """Gather leg of the ring: one int8 all-gather of the mean codes and
    one of the scalar scales per bucket; each scale spread over its
    sub-chunk's elements.  Returns (step_in {bucket: [n] f32}, scales
    {bucket: [n] f32})."""
    g = _groups(spec)
    mesh = spec.mesh
    step, scl = {}, {}
    for b, q in pending["q"].items():
        qg = mesh.all_gather(q[0], g.worker)
        sg = mesh.all_gather(pending["scale"][b].reshape(1), g.worker)
        step[b] = qg.float()
        scl[b] = sg[:, None].expand(sg.shape[0], q.shape[1]).reshape(-1)
    return step, scl


# --------------------------------------------------------------------------
# The re-quantizing int8 ring (`sync_wire="ring-int8"`)
# --------------------------------------------------------------------------

WIRE_MODES = ("auto", "ring-int8")


def check_wire(run_cfg) -> str:
    """Validate + return the wire mode.  ring-int8 rides the quantized sync
    machinery (codes + anchor), so it requires sync_quantize."""
    wire = getattr(run_cfg, "sync_wire", "auto")
    if wire not in WIRE_MODES:
        raise ValueError(f"unknown sync_wire {wire!r}; pick from {WIRE_MODES}")
    if wire == "ring-int8" and not run_cfg.sync_quantize:
        raise ValueError("sync_wire='ring-int8' requires sync_quantize=True "
                         "(the ring carries int8 codes of the delta)")
    return wire


def ring_tolerance(w: int, amax, rounds: int = 1):
    """Worst-case |ring mean - exact mean| bound after `rounds` syncs whose
    per-tensor delta amax never exceeded `amax`: each hop's requantization
    errs at most amax/254 per element, attenuated to k/W of that by the
    remaining folds, plus the final quantize — amax/254 * (W+1)/2 per sync,
    with a 2x safety factor for the fold's own fp32 rounding."""
    return float(amax) * (w + 1) / 254.0 * rounds * 2.0


def ring_codes_host(d, w: int | None = None):
    """Mesh-less int8 ring over one bucket delta d [W, N] (one chunk per
    worker): chunk c's partial seeds at worker (c+1) mod W and folds each
    visitor's contribution through the per-hop requant pass (W - 1
    `ring_combine` and W `ring_quantize_codes` launches per chunk on the
    card).  N is zero-padded to a multiple of W (a zero delta is exact under
    requantization).  Returns (q [W, ceil(N/W)] int8 mean codes, s [W] f32
    per-chunk scales); the scales never leave the device."""
    w = d.shape[0] if w is None else w
    pad = (-d.shape[1]) % w
    if pad:
        d = F.pad(d, (0, pad))
    dc = d.reshape(w, w, d.shape[1] // w)   # [worker, chunk, chunk_len]
    qs, ss = [], []
    for c in range(w):
        j0 = (c + 1) % w
        acc = dc[j0, c]
        s = _guarded_scale(torch.max(torch.abs(acc)))
        q = kops.ring_quantize_codes(acc, s)
        for k in range(1, w):
            acc, amax = kops.ring_combine(q, s, dc[(j0 + k) % w, c], k)
            s = _guarded_scale(amax)
            q = kops.ring_quantize_codes(acc, s)
        qs.append(q)
        ss.append(s)
    return torch.stack(qs), torch.stack(ss)


def _ring_host_begin(spec, params, anchor):
    """Mesh-less ring pending for the flat layout: per bucket
    {"q": [W, C] int8, "scale": [W] f32} with C = ceil(N/W)."""
    out_q, out_s = {}, {}
    for b in spec.buckets:
        d = params[b].float() - anchor[b].float()[None]
        out_q[b], out_s[b] = ring_codes_host(d)
    return {"q": out_q, "scale": out_s}


def _ring_host_gather(pending, anchor):
    """Ring pending -> per-element (step_in, scales) [N] per bucket: the
    codes already ARE the mean (no /W), each chunk's scale spread over its
    elements (an expand, so no host sync)."""
    step, scl = {}, {}
    for b in pending["q"]:
        q, s = pending["q"][b], pending["scale"][b]
        n = anchor[b].shape[0]
        step[b] = q.reshape(-1)[:n].float()
        scl[b] = s[:, None].expand(q.shape).reshape(-1)[:n]
    return step, scl


# --------------------------------------------------------------------------
# The split sync: reduce (begin) | outer update + apply
# --------------------------------------------------------------------------

def make_sync_begin(run_cfg, spec=None, partial: bool = False):
    """First half of the sync: begin(state) -> pending, a pure function of
    the pre-sync state (new tensors; nothing of the state is written).

    pending per bucket/leaf: the worker-mean params in f32 (plain sync), the
    worker-mean delta (momentum-only sync), {"q": worker-mean integer codes,
    "scale": per-element scales} (quantized), or the ring's
    {"q": [W, C] int8, "scale": [W]} (ring-int8, flat layout).

    With a mask, begin(state, mask) ([W] f32 in {0,1} on the state's
    device): plain/momentum pendings arrive divided by |P|; quantized ones
    carry the code sum and {"count": |P|}.  partial=True refuses the ring
    wire, which cannot take a mask."""
    quantize, mom = run_cfg.sync_quantize, run_cfg.outer_momentum
    wire = check_wire(run_cfg)
    coll = _use_collectives(spec)
    if wire == "ring-int8" and spec is None:
        raise ValueError("sync_wire='ring-int8' needs a flat layout "
                         "(--param-layout flat | flat_sharded): the ring "
                         "chunks a bucket, not a pytree leaf")
    if wire == "ring-int8" and partial:
        raise ValueError("sync_wire='ring-int8' does not compose with "
                         "partial participation: the running-mean ring "
                         "bakes W into every hop — use wire='auto'")

    def mean_w(x, mask):
        if coll:
            return _rs_mean(spec, x, _groups(spec).n_workers, mask)
        if mask is None:
            return kref.mean0(x)
        return (x * _lane_mask(mask, x)).sum(0) / mask.sum()

    def begin(state, mask=None):
        params = state["params"]
        if not quantize and mom == 0.0:
            return T.map(lambda p: mean_w(p.float(), mask), params)
        anchor = state["anchor"]
        if wire == "ring-int8":
            return (_ring_quantized_begin(spec, params, anchor) if coll
                    else _ring_host_begin(spec, params, anchor))
        if quantize and coll:
            return _rs_quantized_begin(spec, params, anchor, mask)
        delta = T.map(lambda p, a: p.float() - a.float()[None], params,
                      anchor)
        if coll:
            return T.map(lambda d: mean_w(d, mask), delta)
        if mask is not None:
            # zero absent lanes BEFORE the scale statistic and the quantizer
            delta = T.map(lambda d: d * _lane_mask(mask, d), delta)
        if not quantize:
            if mask is None:
                return T.map(kref.mean0, delta)
            return T.map(lambda d: d.sum(0) / mask.sum(), delta)
        if spec is None:
            scales = T.map(lambda d: _guarded_scale(torch.max(torch.abs(d))),
                           delta)
        else:
            scales = {b: flat_delta_scales(spec, b, params[b], anchor[b],
                                           mask) for b in spec.buckets}
        codes = T.map(lambda d, s: kref.quantize_codes(
            d, s[None] if s.ndim else s), delta, scales)
        if mask is None:
            return {"q": T.map(kref.mean0, codes), "scale": scales}
        return {"q": T.map(lambda q: q.sum(0), codes), "scale": scales,
                "count": mask.sum()}

    return begin


def make_sync_apply(run_cfg, spec=None, partial: bool = False):
    """Second half of the sync: apply(state, pending, entry_params=None) ->
    a NEW state (the input state's tensors are not written, so applying a
    pending sync to the live state is a pure view of it).

      * entry_params=None — exact mode: every lane becomes the consensus.
        Right after begin() this is the blocking sync; deferred to the next
        round with no step in between (overlap depth 0) it stays bitwise
        the blocking trajectory.
      * entry_params given (the params begin() saw) — correction mode for
        overlap depth > 0: x_i <- x_i + (consensus - entry_i).

    Under the flat layout the dequantize + outer update + anchor run as one
    `ops.sync_apply_update` per bucket (the CUDA kernel on the card); under
    the tree layout the plain version per leaf, as the reference does.
    Partial pendings divide their code sums by pending["count"]."""
    quantize, mom = run_cfg.sync_quantize, run_cfg.outer_momentum
    wire = check_wire(run_cfg)
    coll = _use_collectives(spec)
    del partial  # pendings self-describe via their "count" entry

    def gather(x):
        return _ag_mean(spec, x) if coll else x

    def to_params(consensus, params, entry):
        if entry is None:
            # a new tensor, never a view of the consensus (the new anchor):
            # at one lane an expanded view is already contiguous, and the
            # optimizer would then update the anchor in place through it
            return T.map(lambda c, p: torch.empty_like(p).copy_(
                c[None].expand(p.shape)), consensus, params)
        return T.map(lambda c, p, e: (p.float() + (c[None] - e.float()))
                     .to(p.dtype), consensus, params, entry)

    def apply(state, pending, entry_params=None):
        params = state["params"]
        if not quantize and mom == 0.0:
            return {**state, "params": to_params(T.map(gather, pending),
                                                 params, entry_params)}
        if quantize and wire == "ring-int8":
            step_in, scales = (_ag_ring(spec, pending) if coll else
                               _ring_host_gather(pending, state["anchor"]))
        elif quantize and coll:
            div = pending.get("count")
            if div is None:
                div = torch.full((), float(_groups(spec).n_workers),
                                 device=pending["scale"][spec.buckets[0]].device)
            step_in = {b: q.float() / div
                       for b, q in _ag_codes(spec, pending["q"]).items()}
            scales = pending["scale"]
        elif quantize:
            cnt = pending.get("count")
            step_in = (pending["q"] if cnt is None
                       else T.map(lambda q: q / cnt, pending["q"]))
            scales = pending["scale"]
        else:
            step_in, scales = T.map(gather, pending), None
        mu_in = state["outer_mu"] if mom > 0.0 else None
        apply_one = kops.sync_apply_update if spec is not None \
            else kref.sync_apply_update
        ls, treedef = T.flatten(step_in)
        la = T.leaves(state["anchor"])
        lsc = T.leaves(scales) if quantize else [None] * len(ls)
        lmu = T.leaves(mu_in) if mom > 0.0 else [None] * len(ls)
        outs = [apply_one(s, a, scale=sc, mu=m, momentum=mom)
                for s, a, sc, m in zip(ls, la, lsc, lmu)]
        new_state = dict(state)
        new_state["anchor"] = T.unflatten(treedef, [o[0] for o in outs])
        if mom > 0.0:
            new_state["outer_mu"] = T.unflatten(treedef, [o[1] for o in outs])
        new_state["params"] = to_params(new_state["anchor"], params,
                                        entry_params)
        return new_state

    return apply


def make_sync(run_cfg, spec=None):
    """Returns sync(state) -> state.  state = {"params", "opt", "anchor"?,
    "outer_mu"?}; params carry a leading worker axis.  With `spec` (a
    FlatParamSpace) the state is flat: params {bucket: [W, N]},
    anchor/outer_mu {bucket: [N]}, and an anchored sync on the auto wire is
    one fused `sync_flat_update` per bucket (in place on the card).  The
    tree layout, the ring wire and a mesh-carrying ShardedFlatSpace (a
    rank's chunks, the collective halves) compose begin and apply."""
    quantize, mom = run_cfg.sync_quantize, run_cfg.outer_momentum
    wire = check_wire(run_cfg)

    if spec is not None and not _use_collectives(spec) and wire != "ring-int8":
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

    begin = make_sync_begin(run_cfg, spec)
    apply_ = make_sync_apply(run_cfg, spec)

    def sync_composed(state):
        return apply_(state, begin(state))

    return sync_composed


def make_sync_partial(run_cfg, spec=None):
    """Partial-participation sync: sync(state, mask) -> state, the two
    halves composed with a membership mask [W] (module docstring).  Every
    layout runs the composed begin/apply; an all-ones mask is bitwise the
    composed blocking sync for power-of-two W."""
    begin = make_sync_begin(run_cfg, spec, partial=True)
    apply_ = make_sync_apply(run_cfg, spec, partial=True)

    def sync_partial(state, mask):
        return apply_(state, begin(state, mask))

    return sync_partial


SYNC_PROGRAMS = ("blocking", "partial", "begin", "apply")


def sync_program(run_cfg, spec=None, program: str = "blocking"):
    """One callable per sync sub-program, by name: `blocking` and `partial`
    are the whole-sync callables, `begin` / `apply` the overlap halves."""
    if program == "blocking":
        return make_sync(run_cfg, spec=spec)
    if program == "partial":
        return make_sync_partial(run_cfg, spec=spec)
    if program == "begin":
        return make_sync_begin(run_cfg, spec=spec)
    if program == "apply":
        return make_sync_apply(run_cfg, spec=spec)
    raise ConfigError(
        f"unknown sync program {program!r}; pick from {SYNC_PROGRAMS}")
