"""Continuous-batching serving scheduler (port of `repro/launch/batching.py`).

A fixed `slots`-wide decode batch over a shared KV cache: queued requests
are admitted into free slots, their prompts stream through the same
single-token `decode_step` at the slot's own (ragged) position — slot-local
prefill, so there is no separate prefill program — and finished sequences
retire, freeing the slot.

Weights are `ServingWeights` flat dtype buckets (launch/weights.py); the
model reads views into them.  `maybe_swap()` is the swap point, between
decode steps: the "refresh" policy replays every in-flight sequence's known
tokens through the slot-local prefill under the new weights, so post-swap
tokens are what a server restarted on those weights would emit.  Each
emitted token is stamped with the swap epoch active when it was sampled
(`Request.epochs`).

Sampling (temperature > 0) is per request: token t of request r is drawn
with a `torch.Generator` seeded from (seed, r.rid, t), a pure function of
(seed, rid, emitted count) — a request's samples do not depend on which
other requests share the batch, and a post-swap replay rejoins the same
stream.  The stream differs from the JAX package's `fold_in` keys, which
torch cannot reproduce; greedy decoding (temperature 0) is what the two
packages agree on token for token.

An MoE model (the `moe` family) is served like a dense one: every slot's
token, a retired lane's too, goes through the router and takes expert
capacity in the step, so lanes can drop each other's picks where the
capacity binds, as in the reference.

The device is the weights': CUDA unless the caller built them with
`device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.errors import ConfigError
from repro_torch.launch.weights import ServingWeights, WeightSubscriber
from repro_torch.models import api


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    epochs: list = dataclasses.field(default_factory=list)  # swap epoch per token
    done: bool = False
    _cursor: int = 0            # next sequence index to feed (prompt, then out)


def sample_generator(seed: int, rid: int, t: int) -> torch.Generator:
    """The CPU generator that draws token t of request rid."""
    state = np.random.SeedSequence([seed, rid, t]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))


# why the service loop refuses the hybrid family (zamba2)
HYBRID_SLOTS = (
    "--slots: the hybrid family's decode step takes one position for the "
    "whole batch; the reference's zamba2.decode_step builds positions "
    "pos[None, None] and fails on the batcher's per-slot positions, so the "
    "service loop refuses it; serve it one-shot (without --slots)")


class ContinuousBatcher:
    """Fixed `slots`-wide decode batch over a shared KV cache (or an SSM's
    recurrent state, which `api.zero_cache_slots` clears on admission).
    Refuses the hybrid family (`HYBRID_SLOTS`)."""

    def __init__(self, cfg, params, *, slots: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 subscriber: WeightSubscriber | None = None, device=None):
        if cfg.family == "hybrid":
            raise ConfigError(HYBRID_SLOTS)
        self.cfg = cfg
        self.mod = api.get_module(cfg)
        if isinstance(params, ServingWeights):       # carries its device
            if device is not None and \
                    torch.device(device).type != params.device.type:
                raise ValueError(f"weights live on {params.device}, "
                                 f"not {device}")
            self.weights = params
        else:
            self.weights = ServingWeights(cfg, params, device=device)
        self.device = self.weights.device
        self.subscriber = subscriber
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        self.cache = self.mod.init_cache(cfg, slots, max_len,
                                         dtype=torch.float32,
                                         device=self.device)
        self.pos = np.zeros(slots, np.int32)       # next write position
        self.active: list[Request | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.tokens_emitted = 0
        self.swaps = 0
        self.decode_steps = 0

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.max_len:
            # reject, don't truncate: the lane cannot hold the prompt
            raise ValueError(
                f"prompt of request {req.rid} is {len(req.prompt)} tokens "
                f"but the cache holds max_len={self.max_len}")
        self.queue.append(req)

    # -- hot weight swap ----------------------------------------------------

    def maybe_swap(self) -> bool:
        """The swap point, between decode steps.  Polls the subscriber's
        watch dir, takes the newest published weights (if any), swaps the
        flat buckets in place, and REFRESHES every in-flight sequence:
        cursor and cache lane reset so the known tokens replay through the
        slot-local prefill under the new weights."""
        if self.subscriber is None:
            return False
        self.subscriber.poll()
        got = self.subscriber.take()
        if got is None:
            return False
        step, source, params = got
        if step <= self.weights.step:
            return False
        self.weights.swap(params, step=step, source=source,
                          tokens_before=self.tokens_emitted)
        self.swaps += 1
        live = [s for s, r in enumerate(self.active) if r is not None]
        for s in live:
            self.active[s]._cursor = 0
            self.pos[s] = 0
        if live:
            api.zero_cache_slots(self.cache, live)
        return True

    # -- internals ----------------------------------------------------------

    def _admit(self) -> None:
        admitted = []
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req._cursor = 0
            self.active[s] = req
            self.pos[s] = 0
            admitted.append(s)
        if admitted:
            # a recycled lane is cleared: KV survives a dirty lane by
            # positional overwrite + the causal mask, but a family with
            # recurrent state would leak the previous request
            api.zero_cache_slots(self.cache, admitted)

    def _slot_token(self, s: int) -> int:
        """Sequence token at the slot's cursor: prompt, then emitted tokens
        (the replay form a post-swap refresh depends on)."""
        req = self.active[s]
        if req is None:
            return 0
        i = req._cursor
        if i < len(req.prompt):
            return int(req.prompt[i])
        return int(req.out[i - len(req.prompt)])

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature <= 0:
            return torch.argmax(logits, -1).cpu().numpy()
        scaled = (logits / self.temperature).cpu()
        out = np.zeros(self.slots, np.int64)
        for s, r in enumerate(self.active):
            if r is None:
                continue
            # Gumbel-max: argmax(logits/T + Gumbel) is a categorical draw
            u = torch.rand(scaled.shape[-1], dtype=torch.float64,
                           generator=sample_generator(self.seed, r.rid,
                                                      len(r.out)))
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-300)))
            out[s] = int(torch.argmax(scaled[s].double() + gumbel))
        return out

    @torch.no_grad()
    def step(self) -> int:
        """One decode step over all slots. Returns #active sequences."""
        self.maybe_swap()
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        toks = torch.tensor([self._slot_token(s) for s in range(self.slots)],
                            dtype=torch.long, device=self.device)
        # per-slot (ragged) positions: each slot writes/attends at its own
        # cursor.  A retired lane still sits at its last position (up to
        # max_len); its cache write is clamped to the last row.
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        logits, self.cache = self.mod.decode_step(
            self.cfg, self.weights.as_tree(), toks, self.cache, pos)
        self.decode_steps += 1
        nxt = self._next_tokens(logits)
        n_active = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            n_active += 1
            self.pos[s] += 1
            known = len(req.prompt) + len(req.out)
            if req._cursor < known - 1:
                req._cursor += 1    # prefilling (or post-swap replaying)
                continue
            req._cursor += 1
            req.out.append(int(nxt[s]))
            req.epochs.append(self.weights.epoch)
            self.tokens_emitted += 1
            # the last legal cache write is position max_len-1, whose decode
            # just produced one more sampled token — retire at pos==max_len
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len:
                req.done = True
                self.active[s] = None       # retire; slot is reusable
        return n_active

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
