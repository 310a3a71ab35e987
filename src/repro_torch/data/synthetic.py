"""Deterministic synthetic data (port of `repro/data/synthetic.py`).

`TokenStream` (an order-1 Markov language, so the loss is learnable) and
`VisionStream` (noisy teacher labels over random images) are the JAX
package's numpy code copied exactly — the same RandomState seeds and draws
— so both packages see bitwise the same batches; only the return type
differs (CPU torch tensors here, moved to the run's device by the engine).
`make_train_batch` stacks the W workers' token batches as the reference's
host path does; a vlm batch also carries `prefix_embeds`, 0.02 · normal,
and an audio batch `frames`, 0.1 · normal, each from a `torch.Generator`
seeded from the step as the reference seeds its `PRNGKey` (`step * 131 +
7` and `+ 11`): the reference's distributions, not its bits (`jax.random`
has no twin).

`device_batch_fn` is the port of the reference's on-device synthesis
(`RoundEngine(data="device")`): the same Markov process and extras, drawn
on the run's device from a `torch.Generator` seeded from (stream seed,
step) alone, so a batch needs no host draw and no host-to-device copy.
Like the reference's, it gives the same language as `TokenStream`, not the
same batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as T


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


def vision_batch_fn(stream: VisionStream, workers: int, b_loc: int,
                    lanes=None):
    """Host `batch_fn(step) -> {"images": [W, B, H, W, C], "labels": [W, B]}`
    for `RoundEngine(data="host")`: worker w draws `stream.batch(step, w,
    b_loc)`, as `examples/vit_local_adamw.py` stacks them.  `lanes` (worker
    indices) draws those workers' lanes alone, the same bits: a mesh rank's
    batch is `lanes=[i]`."""
    lanes = range(workers) if lanes is None else lanes

    def batch_fn(step: int) -> dict:
        xs, ys = zip(*[stream.batch(step, w, b_loc) for w in lanes])
        return {"images": torch.stack(xs), "labels": torch.stack(ys)}
    return batch_fn


def effective_batch_view(batch, lanes: int, axis: int = 1):
    """View `batch` (leaves [..., B, ...] with the per-worker batch at
    `axis`) as an effective batch of `lanes` samples without changing any
    shape: samples [0, lanes) are tiled over the B slots (`idx = arange(B)
    % lanes`, gathered on the batch's device), so when `lanes` divides B
    the mean loss and gradient are exactly those of a batch-`lanes` step
    (each distinct sample weighted B / lanes times; the weights cancel in
    the mean).  The adaptive controller's batch knob (`core/controller.py`,
    through `RoundEngine.batch_epoch`).  Leaves with `ndim <= axis` pass
    through; at lanes == B the index is the identity and every leaf is
    returned as it is (the reference gathers it: the same bits)."""
    lanes = int(lanes)

    def take(x):
        if x.ndim <= axis or lanes >= x.shape[axis]:
            return x
        idx = torch.arange(x.shape[axis], device=x.device) % lanes
        return torch.index_select(x, axis, idx)
    return T.map(take, batch)


def device_batch_fn(cfg, stream: TokenStream, w: int, b_loc: int, seq: int,
                    device):
    """On-device batch synthesis: `synth(step) -> batch [W, B_loc, ...]` on
    `device`, as the reference's `device_batch_fn`.

    The order-1 Markov process of `TokenStream.batch` (the same transition
    table `stream.succ`, `branch` and noise rate): a first token uniform
    over the vocab, then each next token a uniform pick among the current
    token's `branch` successors, replaced with probability `noise` by a
    uniform token.  `tokens` are the first `seq` of the `seq + 1` tokens,
    `labels` the last `seq` (the next token).  A vlm config's batch also
    holds `prefix_embeds` [W, B_loc, n_img_tokens, D] (0.02 · normal), an
    audio config's `frames` [W, B_loc, enc_seq, D] (0.1 · normal).  Every
    number comes from one `torch.Generator` on `device`, seeded from
    (stream.seed, step) and nothing else: a batch is a function of the two,
    whatever ran before."""
    device = torch.device(device)
    succ = torch.as_tensor(stream.succ, dtype=torch.int64,
                           device=device).reshape(-1)      # [vocab * branch]
    vocab, branch, noise = stream.vocab, stream.branch, stream.noise

    def synth(step: int) -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(stream.seed) * 2**32 + int(step))

        def randint(hi, shape):
            return torch.randint(0, hi, shape, generator=gen, device=device)

        shape = (seq, w, b_loc)
        tok = randint(vocab, (w, b_loc))
        pick = randint(branch, shape)
        flip = torch.rand(shape, generator=gen, device=device) < noise
        other = randint(vocab, shape)
        chain = torch.empty((seq + 1, w, b_loc), dtype=torch.int64,
                            device=device)
        chain[0] = tok
        for t in range(seq):        # 3 launches a token: add, gather, where
            tok = torch.where(flip[t], other[t],
                              succ[torch.add(pick[t], tok, alpha=branch)],
                              out=chain[t + 1])
        chain = chain.permute(1, 2, 0).to(torch.int32)      # [W, B, seq+1]
        batch = {"tokens": chain[..., :-1].contiguous(),
                 "labels": chain[..., 1:].contiguous()}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = 0.02 * torch.randn(
                (w, b_loc, cfg.n_img_tokens, cfg.d_model), generator=gen,
                device=device)
        if cfg.family == "audio":
            batch["frames"] = 0.1 * torch.randn(
                (w, b_loc, cfg.enc_seq, cfg.d_model), generator=gen,
                device=device)
        return batch

    return synth


def make_train_batch(cfg, stream: TokenStream, step: int, w: int, b_loc: int,
                     seq: int, lanes=None) -> dict:
    """Stacked per-worker batch {"tokens", "labels"} [W, B_loc, seq] (CPU
    int32) for the local-gradient runtime; a vlm config's also holds
    "prefix_embeds" [W, B_loc, n_img_tokens, d_model], an audio config's
    "frames" [W, B_loc, enc_seq, d_model] (CPU fp32, 0.02 · and 0.1 ·
    normal, functions of the step alone).  `lanes` (worker indices) keeps
    those workers' lanes, the same bits: their tokens are drawn alone, the
    prefix or frames for all W and then indexed."""
    idx = list(range(w)) if lanes is None else list(lanes)
    toks, labels = zip(*[stream.batch(step, k, b_loc, seq) for k in idx])
    batch = {"tokens": torch.stack(toks), "labels": torch.stack(labels)}
    if cfg.family == "vlm":
        gen = torch.Generator().manual_seed(step * 131 + 7)
        batch["prefix_embeds"] = 0.02 * torch.randn(
            (w, b_loc, cfg.n_img_tokens, cfg.d_model), generator=gen)
    if cfg.family == "audio":
        gen = torch.Generator().manual_seed(step * 131 + 11)
        batch["frames"] = 0.1 * torch.randn(
            (w, b_loc, cfg.enc_seq, cfg.d_model), generator=gen)
    if lanes is not None:
        for k in ("prefix_embeds", "frames"):
            if k in batch:
                batch[k] = batch[k][idx]
    return batch
