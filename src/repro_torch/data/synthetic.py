"""Deterministic synthetic data (port of `repro/data/synthetic.py`, vision
stream).

`VisionStream` is the JAX package's numpy code copied exactly — the same
RandomState seeds and draws — so both packages see bitwise the same
batches; only the return type differs (CPU torch tensors here, moved to the
run's device by the engine).  `TokenStream` and `make_train_batch` wait for
the LM training slice; `device_batch_fn` draws from `jax.random` and has no
twin.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
