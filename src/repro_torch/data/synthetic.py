"""Deterministic synthetic data (port of `repro/data/synthetic.py`).

`TokenStream` (an order-1 Markov language, so the loss is learnable) and
`VisionStream` (noisy teacher labels over random images) are the JAX
package's numpy code copied exactly — the same RandomState seeds and draws
— so both packages see bitwise the same batches; only the return type
differs (CPU torch tensors here, moved to the run's device by the engine).
`make_train_batch` stacks the W workers' token batches as the reference's
host path does; a vlm batch also carries `prefix_embeds`, 0.02 · normal
from a `torch.Generator` seeded from the step as the reference seeds its
`PRNGKey` (`step * 131 + 7`): the reference's distribution, not its bits
(`jax.random` has no twin).  Its audio branch raises (whisper is not
ported).  The reference's `device_batch_fn` draws its batches inside the
jitted round from `jax.random`, which has no PyTorch twin either: the port
runs the host stream only (`RoundEngine(data="host")`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.errors import ConfigError


@dataclasses.dataclass
class TokenStream:
    """Order-1 Markov LM over `vocab` symbols with `branch` likely successors."""
    vocab: int
    seed: int = 0
    branch: int = 4

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # sparse transition table: each symbol has `branch` likely successors
        self.succ = rng.randint(0, self.vocab, size=(self.vocab, self.branch))
        self.noise = 0.1

    def batch(self, step: int, worker: int, batch: int, seq: int):
        """Returns (tokens, labels) int32 [batch, seq] CPU tensors; labels =
        next token."""
        seed = (step * 1000003 + worker * 7919 + self.seed) % (2**31)
        rng = np.random.RandomState(seed)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.randint(0, self.vocab, size=batch)
        for t in range(seq):
            nxt = self.succ[toks[:, t], rng.randint(0, self.branch, size=batch)]
            flip = rng.rand(batch) < self.noise
            nxt = np.where(flip, rng.randint(0, self.vocab, size=batch), nxt)
            toks[:, t + 1] = nxt
        return (torch.from_numpy(toks[:, :-1].astype(np.int32)),
                torch.from_numpy(toks[:, 1:].astype(np.int32)))


@dataclasses.dataclass
class VisionStream:
    """Teacher-labeled random images with label noise (K-class)."""
    n_classes: int
    image: int = 32
    channels: int = 3
    seed: int = 0
    label_noise: float = 0.1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        d = self.image * self.image * self.channels
        self.w1 = rng.randn(d, 64).astype(np.float32) / np.sqrt(d)
        self.w2 = rng.randn(64, self.n_classes).astype(np.float32) / 8.0

    def batch(self, step: int, worker: int, batch: int, *, noisy=True):
        """-> (images fp32 [batch, image, image, channels], labels int32
        [batch]) as CPU tensors."""
        seed = (step * 999983 + worker * 31337 + self.seed) % (2**31)
        rng = np.random.RandomState(seed)
        x = rng.randn(batch, self.image, self.image,
                      self.channels).astype(np.float32)
        h = np.tanh(x.reshape(batch, -1) @ self.w1) @ self.w2
        y = h.argmax(-1)
        if noisy and self.label_noise:
            flip = rng.rand(batch) < self.label_noise
            y = np.where(flip, rng.randint(0, self.n_classes, size=batch), y)
        return torch.from_numpy(x), torch.from_numpy(y.astype(np.int32))


def vision_batch_fn(stream: VisionStream, workers: int, b_loc: int):
    """Host `batch_fn(step) -> {"images": [W, B, H, W, C], "labels": [W, B]}`
    for `RoundEngine(data="host")`: worker w draws `stream.batch(step, w,
    b_loc)`, as `examples/vit_local_adamw.py` stacks them."""
    def batch_fn(step: int) -> dict:
        xs, ys = zip(*[stream.batch(step, w, b_loc) for w in range(workers)])
        return {"images": torch.stack(xs), "labels": torch.stack(ys)}
    return batch_fn


def make_train_batch(cfg, stream: TokenStream, step: int, w: int, b_loc: int,
                     seq: int) -> dict:
    """Stacked per-worker batch {"tokens", "labels"} [W, B_loc, seq] (CPU
    int32) for the local-gradient runtime; a vlm config's also holds
    "prefix_embeds" [W, B_loc, n_img_tokens, d_model] (CPU fp32, 0.02 ·
    normal, a function of the step alone)."""
    if cfg.family == "audio":
        raise ConfigError("audio training batches: not ported yet")
    toks, labels = zip(*[stream.batch(step, k, b_loc, seq)
                         for k in range(w)])
    batch = {"tokens": torch.stack(toks), "labels": torch.stack(labels)}
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(step * 131 + 7)
        batch["prefix_embeds"] = 0.02 * torch.randn(
            (w, b_loc, cfg.n_img_tokens, cfg.d_model), generator=gen)
    return batch
