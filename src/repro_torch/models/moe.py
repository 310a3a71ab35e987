"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(port of `repro/models/moe.py`).

Dispatch is sort-based: each token's k expert picks are sorted by expert id
(a stable sort, so within an expert the earlier tokens come first), the
first `capacity` picks of each expert are scattered into an [E, C, d]
buffer and the rest dropped, the experts run as three batched products over
that buffer, and the combine gathers each pick's row back and weights it by
the renormalized router probability.  Covers dbrx-132b (16 experts, top-4)
and kimi-k2 (384 experts, top-8, one shared expert).

The reference computes the experts with XLA einsums, outside any Pallas
kernel, so here they are `torch.bmm` in fp32 (TF32 is off, `common.py`);
the dispatch and the combine are plain torch too.  Only the shared expert
goes through the `swiglu` kernel on the card (`common.mlp_apply`).

The reference picks the dispatch through module globals that `make_loss`
sets (`set_dispatch_shards`, `set_dispatch`); here `moe_apply` takes
`shards` as an argument, which `core/local_update.py make_loss` reads
from the RunConfig (`moe_dispatch_shards`; its `moe_dispatch` mode goes
through `check_mode`).  A server passes none: global dispatch, as the
reference's serve path runs (it never calls `make_loss`).  `shards > 1`
with the tokens divisible by it is the shard-local dispatch: routing,
sort and a capacity of `capacity(cfg, T / shards)` per shard, one buffer
[E, shards * C, d] for the expert products.  The `shard_map` mode needs a
device mesh and an all-to-all and raises until the distributed slice is
ported; the other modes dispatch by `shards` alone, as the reference's
do.

Nothing here reads a value back to the host (no boolean indexing, no
`nonzero`, no `.item()`): a decode step stays free of device syncs and can
be captured in a CUDA graph, and a layer recomputed under
`torch.utils.checkpoint` routes its tokens the same way (sort and top-k
are deterministic, the scatter's sums exact in any order, and nothing
reads a generator).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError
from repro_torch.models import common as cm
from repro_torch.models.param import ParamDef

# the RunConfig's `moe_dispatch` modes the port runs (the reference's
# fourth, "shard_map", raises)
MODES = ("auto", "global", "sharded")


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None)),
        "wi": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "wg": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = cm.mlp_defs(cfg, d_ff=cfg.d_ff * cfg.n_shared_experts)
    return defs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows of each expert's buffer: ceil(T k cf / E), at least 8 and a
    multiple of 8.  So a batch of at most 8 tokens (a decode step of up to
    8 slots) never drops a pick, and every expert runs on every step."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def check_mode(mode: str) -> None:
    """Raise unless the RunConfig's `moe_dispatch` is a mode the port
    runs."""
    if mode == "shard_map":
        raise ConfigError("moe_dispatch='shard_map' (an all-to-all over a "
                          "device mesh): not ported yet")
    if mode not in MODES:
        raise ConfigError(f"unknown moe_dispatch {mode!r}")


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              shards: int = 1):
    """x [B,S,d] -> (out [B,S,d], aux_loss 0-d fp32).  shards > 1 (and
    dividing B S): the shard-local dispatch (`_moe_apply_sharded` in the
    reference); otherwise the global one."""
    b, s, d = x.shape
    t = b * s
    if shards <= 1 or t % shards:
        shards = 1
    e, k = cfg.n_experts, cfg.top_k
    tl = t // shards
    xf = x.reshape(t, d)
    dev = x.device

    logits = xf.float().reshape(shards, tl, d) @ p["router"].float()
    probs = torch.softmax(logits, -1)                          # [sh,tl,E]
    # `lax.top_k` puts the lower index first among equal values; torch.topk
    # may order such picks otherwise.  That reorders a token's k picks
    # only, among distinct experts: the dispatch (sorted by expert, then
    # token) is the same, and only the combine's sum over k may differ in
    # order
    top_p, top_i = torch.topk(probs, k, dim=-1)                # [sh,tl,k]
    top_p = top_p / torch.sum(top_p, -1, keepdim=True)         # renormalize

    # ---- load-balance aux loss (Switch/GShard style) ----
    # me (the mean router probability) and top_p carry the gradient into
    # the router; the token fraction ce is a count.  Counted by index_add:
    # sums of ones, exact in fp32 in any order, as the reference's one-hot
    # sum is
    me = torch.mean(probs, (0, 1))
    counts = torch.zeros(e, dtype=torch.float32, device=dev).index_add(
        0, top_i.reshape(-1), torch.ones(t * k, device=dev))
    ce = counts / t / k
    aux = e * torch.sum(me * ce)

    # ---- sort-based capacity dispatch, per shard ----
    c = capacity(cfg, tl)
    flat_e = top_i.reshape(shards, tl * k)
    # `jnp.argsort` is stable: so is this sort, or capacity would drop
    # other tokens (within an expert the earlier token keeps its place)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # side="left", as `jnp.searchsorted`
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).repeat(shards, 1))  # [sh,E]
    pos_in_e = (torch.arange(tl * k, device=dev)[None]
                - torch.gather(seg_start, 1, sorted_e))
    keep = (pos_in_e < c).reshape(-1, 1).to(xf.dtype)
    pos_cl = torch.clamp(pos_in_e, max=c - 1)
    shard = torch.arange(shards, device=dev)[:, None]
    tok = (order // k + shard * tl).reshape(-1)                # into xf
    # the buffer [E, shards, C, d], flat: (expert, shard, slot) -> one row
    row = (sorted_e * (shards * c) + shard * c + pos_cl).reshape(-1)

    # `buf.at[sorted_e, pos_cl].add(src)`, out of place, so that autograd
    # carries a gather back to x.  A dropped pick adds zeros into its
    # expert's last slot, so the sums do not depend on the adds' order
    src = xf[tok] * keep
    buf = xf.new_zeros(e * shards * c, d).index_add(0, row, src)
    buf = buf.view(e, shards * c, d)

    # ---- the experts: the reference's einsums, as batched products ----
    hg = torch.bmm(buf, p["wg"])
    hi = torch.bmm(buf, p["wi"])
    hout = torch.bmm(F.silu(hg) * hi, p["wo"]).reshape(e * shards * c, d)

    # ---- combine: gather back, unsort, weight by router prob ----
    gathered = hout[row] * keep                                 # sorted order
    # the inverse of each shard's sort (the reference's argsort(order)),
    # as a scatter: pick j of shard s sits at inv[s tl k + j]
    base = shard * (tl * k)
    inv = torch.empty(shards * tl * k, dtype=order.dtype, device=dev)
    inv[(order + base).reshape(-1)] = (
        torch.arange(tl * k, device=dev)[None] + base).reshape(-1)
    per_slot = gathered[inv].reshape(t, k, d)
    out = torch.sum(per_slot * top_p.reshape(t, k, 1).to(per_slot.dtype), 1)

    if cfg.n_shared_experts:
        out = out + cm.mlp_apply(cfg, p["shared"], xf)
    return out.reshape(b, s, d).to(x.dtype), aux
