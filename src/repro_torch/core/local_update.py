"""Local-gradient runtime, paper Alg. 2 (port of `repro/core/local_update.py`).

Worker replicas are an explicit leading axis `W` on params and optimizer
state, so replicas diverge between syncs.  A local step is a per-worker
loss and gradient plus an elementwise optimizer update (no cross-worker
communication); the sync is a W-axis mean every H steps.

Where the reference vmaps the per-worker loss and gradient, the port keeps
each state leaf (each dtype bucket, under the flat layout) as ONE `[W, ...]`
tensor, makes a grad-requiring alias of it, runs each worker's forward on
the views `[w]`, sums the W losses and runs one backward into the alias's
`.grad`.  The workers share no parameter, so each worker's slice of the
gradient is exactly its own gradient.  Under the flat layout the gradient
is taken with respect to the `[W, N]` buckets through
`FlatParamSpace.unflatten`'s views, which scatters each leaf's gradient
into its slice: bitwise the tree layout's per-leaf gradient.  On a mesh
(`make_mesh_local_step`) a rank gathers its worker's buckets over its
shard group, takes the gradient at W = 1 and updates only its own chunk:
every rank of a shard group computes the worker's whole step (the
reference's GSPMD splits that compute; the port does not yet).  The
optimizer then updates the state tensors under `torch.no_grad()` (in place
on the card).  Folding the W workers into one batched product is later
work.

`RunConfig.microbatch = mb > 1` accumulates the gradient over mb
sequential chunks of each worker's batch (rows [c B/mb, (c+1) B/mb) of
chunk c, as the reference's reshape `(mb, B // mb)` takes them): one
backward per chunk over the W workers' chunk losses.  The reference sums
`acc + g / mb` from zeros; the port lets autograd add each chunk's
gradient into the `.grad` in place and divides by mb once at the end, so
that a chunk's gradient lives one leaf at a time beside the
accumulator, not all of it (at mb = 2 the whole gradient held twice would
cost what the halved activations save).  For a power-of-two mb the two
orders give the same bits (a power-of-two scale is exact in fp32, away
from subnormals); for another mb they differ by a rounding per element.
The loss is summed in the reference's order, `acc + loss / mb` from zero.
A batch that mb does not divide raises `ConfigError` (the reference fails
inside its reshape).  An MoE model sizes its expert capacity per chunk, as
the reference's does.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import torch
# torch.utils.checkpoint (the models' remat) imports torch._dynamo on its
# first call; imported there, under the training frames, the import keeps
# those frames, and the run's state in their locals, alive in a reference
# cycle.  Imported here, before any run, and not by the models, so that
# a server, which loads them too, does not pay for the import
import torch._dynamo  # noqa: F401

from repro_torch import tree as T
from repro_torch.core.sync import make_sync
from repro_torch.errors import ConfigError
from repro_torch.models import api, moe
from repro_torch.optim.optimizers import make_optimizer

Tree = Any


def replicate_for_workers(tree: Tree, w: int) -> Tree:
    """Every leaf `x` -> a new contiguous `[W, *x.shape]` copy."""
    return T.map(lambda x: x[None].expand((w,) + tuple(x.shape)).clone(),
                 tree)


def init_state(cfg, run_cfg, params_single: Tree, w: int) -> Tree:
    """Runtime state with a leading worker axis W.  The anchor is a copy of
    `params_single` (the sync may update it in place)."""
    opt = make_optimizer(run_cfg)
    params = replicate_for_workers(params_single, w)
    state = {"params": params, "opt": opt.init(params)}
    if run_cfg.sync_quantize or run_cfg.outer_momentum > 0.0:
        state["anchor"] = T.map(torch.clone, params_single)
        if run_cfg.outer_momentum > 0.0:
            state["outer_mu"] = T.map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params_single)
    return state


def make_loss(cfg, run_cfg):
    """loss(params, batch) -> scalar, with the run's remat policy; an MoE
    model's with the run's dispatch (`moe_dispatch_shards`,
    `moe_dispatch`), handed to the loss as arguments where the reference
    sets module globals.  `moe_dispatch="shard_map"` raises."""
    kw = {}
    if cfg.n_experts:
        moe.check_mode(run_cfg.moe_dispatch)
        kw["moe_shards"] = max(1, int(run_cfg.moe_dispatch_shards))
    return partial(api.get_module(cfg).loss_fn, cfg,
                   remat=bool(run_cfg.remat), **kw)


def make_worker_grads(cfg, run_cfg, spec=None):
    """grads(params, batch) -> (grads, losses): each worker's gradient of its
    own loss, a tree like `params` (leaves `[W, ...]`, or `{bucket: [W,
    N]}` with `spec`), and the W losses [W] (detached).  With
    `run_cfg.microbatch` > 1 the gradient is accumulated over that many
    chunks of each worker's batch (the module docstring)."""
    loss_fn = make_loss(cfg, run_cfg)
    mb = max(1, int(run_cfg.microbatch))

    def worker_losses(treedef, lanes, batch):
        """The W workers' losses [W], each on its own params' views (call
        with grad enabled)."""
        losses = []
        for i in range(T.leaves(batch)[0].shape[0]):
            pw = T.unflatten(treedef, [lane[i] for lane in lanes])
            if spec is not None:
                pw = spec.unflatten(pw)
            losses.append(loss_fn(pw, T.map(lambda x: x[i], batch)))
        return torch.stack(losses)

    def grads_fn(params, batch):
        leaves, treedef = T.flatten(params)
        alias = [x.detach().requires_grad_(True) for x in leaves]
        lanes = [x.unbind(0) for x in alias]
        w, b = T.leaves(batch)[0].shape[:2]
        if b % mb:
            raise ConfigError(
                f"microbatch {mb} does not divide the per-worker batch {b}")
        n = b // mb
        losses = torch.zeros(w, dtype=torch.float32, device=leaves[0].device)
        for c in range(mb):
            chunk = (batch if mb == 1
                     else T.map(lambda x: x[:, c * n:(c + 1) * n], batch))
            with torch.enable_grad():
                loss_c = worker_losses(treedef, lanes, chunk)
                # into each alias's .grad, in place (module docstring)
                torch.autograd.backward(loss_c.sum(), inputs=alias)
            losses = losses + loss_c.detach() / mb
        grads = [x.grad if mb == 1 else x.grad.div_(mb) for x in alias]
        return T.unflatten(treedef, grads), losses

    return grads_fn


def _lane_norms(grads) -> torch.Tensor:
    """Each worker's global gradient L2 norm [W], lane by lane: a whole
    leaf's squares at once (10 GiB for gemma3-4b's stacked embedding
    gradient at W = 4) would be the step's largest transient."""
    sq = sum(torch.stack([torch.sum(torch.square(gl.float())) for gl in g])
             for g in T.leaves(grads))
    return torch.sqrt(sq)


def make_local_step(cfg, run_cfg, *, with_metrics: bool = False, spec=None):
    """One per-worker optimizer step: NO cross-worker communication.

    state leaves carry the leading worker axis W, batch leaves too.  Returns
    local_step(state, batch, lr) -> (state, loss) or, with `with_metrics`,
    (state, (loss, grad_norm)): the mean over workers of the W losses and of
    each worker's global gradient L2 norm, as 0-d device tensors.  With
    `spec` (a FlatParamSpace) params/opt are `{bucket: [W, N]}` buffers.
    With `run_cfg.microbatch` > 1 the gradient is accumulated over that many
    chunks of each worker's batch (the module docstring)."""
    grads_fn = make_worker_grads(cfg, run_cfg, spec)
    opt = make_optimizer(run_cfg)

    def local_step(state, batch, lr):
        grads, losses = grads_fn(state["params"], batch)
        with torch.no_grad():
            params, opt_state = opt.update(state["params"], state["opt"],
                                           grads, lr)
            new_state = {**state, "params": params, "opt": opt_state}
            loss = torch.mean(losses)
            if not with_metrics:
                return new_state, loss
            return new_state, (loss, torch.mean(_lane_norms(grads)))

    return local_step


def make_mesh_local_step(cfg, run_cfg, spec):
    """The local step of one rank of a mesh (`spec`: a mesh-carrying
    ShardedFlatSpace): the rank holds its worker's chunk `[1, n]` of each
    bucket of params, m and v.

      1. all-gather the worker's buckets over the shard group ([1, N]);
      2. the local step's gradient at W = 1 on the rank's lane of the batch;
      3. keep the rank's chunk of the gradient;
      4. the optimizer (`adamw_update` on the card) on the chunks.

    A global-norm clip reads the whole gradient, which every rank of the
    shard group holds.  Returns local_step(state, batch, lr) -> (state,
    (loss, grad_norm)): this worker's loss and gradient norm, 0-d device
    tensors (the engine averages them over the worker group)."""
    grads_fn = make_worker_grads(cfg, run_cfg, spec)
    opt = make_optimizer(run_cfg)
    groups = spec.mesh.groups(spec.worker_axes)

    def local_step(state, batch, lr):
        with torch.no_grad():
            full = {b: spec.mesh.all_gather(x[0], groups.shard)[None]
                    for b, x in state["params"].items()}
        grads, losses = grads_fn(full, batch)
        with torch.no_grad():
            norm = _lane_norms(grads)
            chunk = {}
            for b, g in grads.items():
                n = state["params"][b].shape[1]
                lo = groups.shard_index * n
                # a new tensor: the optimizer kernel wants 16-byte aligned
                # operands, and lo need not be a multiple of 4
                chunk[b] = g[:, lo:lo + n].clone()
            del full, grads
            params, opt_state = opt.update(state["params"], state["opt"],
                                           chunk, lr, grad_norm=norm[0])
            new_state = {**state, "params": params, "opt": opt_state}
            return new_state, (losses[0], norm[0])

    return local_step


def make_train_round(cfg, run_cfg):
    """(state, batches [H of [W, ...]], lrs [H]) -> (state, mean_loss): the
    paper-faithful communication round, H local steps then one parameter-
    average sync (tree layout)."""
    local_step = make_local_step(cfg, run_cfg)
    sync = make_sync(run_cfg)

    def round_fn(state, batches, lrs):
        losses = []
        for batch, lr in zip(batches, lrs):
            state, loss = local_step(state, batch, lr)
            losses.append(loss)
        with torch.no_grad():
            return sync(state), torch.mean(torch.stack(losses))

    return round_fn
