"""Synthetic datasets: the paper's evaluation geometries, in PyTorch.

Counterpart of `repro.data.synthetic`. Every draw goes through numpy's
seeded generator exactly as the JAX package draws it, so both packages get
bit-identical data from one seed. Returns CPU tensors: features float32,
labels int32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_circles", "make_moons", "make_gaussian_blobs", "flip_labels",
           "make_token_batch"]


def _tensors(x: np.ndarray, y: np.ndarray):
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y)


def make_circles(n_per_class: int, noise: float = 0.05, seed: int = 0):
    """Two concentric circles (paper Sec. 4, Fig. 3). Returns (x, y)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, size=2 * n_per_class)
    r = np.concatenate([np.full(n_per_class, 1.0), np.full(n_per_class, 0.5)])
    x = np.stack([r * np.cos(theta), r * np.sin(theta)], -1)
    x += rng.normal(scale=noise, size=x.shape)
    y = np.concatenate([np.zeros(n_per_class), np.ones(n_per_class)]
                       ).astype(np.int32)
    return _tensors(x, y)


def make_moons(n_per_class: int, noise: float = 0.05, seed: int = 0):
    """Two interleaved half-moons (paper Appendix B). Returns (x, y)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, size=n_per_class)
    x0 = np.stack([np.cos(t), np.sin(t)], -1)
    x1 = np.stack([1.0 - np.cos(t), 0.5 - np.sin(t)], -1)
    x = np.concatenate([x0, x1], 0) + rng.normal(
        scale=noise, size=(2 * n_per_class, 2))
    y = np.concatenate([np.zeros(n_per_class), np.ones(n_per_class)]
                       ).astype(np.int32)
    return _tensors(x, y)


def make_gaussian_blobs(n_per_class: int, num_classes: int = 2, dim: int = 2,
                        spread: float = 0.3, seed: int = 0):
    """`num_classes` Gaussian blobs of `n_per_class` points in `dim`
    dimensions around centres drawn from the same seed. Returns (x, y),
    classes in order."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, dim)) * 2.0
    x = np.concatenate(
        [centers[c] + rng.normal(scale=spread, size=(n_per_class, dim))
         for c in range(num_classes)], 0)
    y = np.repeat(np.arange(num_classes), n_per_class).astype(np.int32)
    return _tensors(x, y)


def flip_labels(y, frac: float, num_classes: int, seed: int = 0):
    """Mislabel a fraction of points (paper Fig. 5). Returns (y_noisy,
    mask) as CPU tensors."""
    rng = np.random.default_rng(seed)
    y_np = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    n = y_np.shape[0]
    idx = rng.choice(n, size=max(1, int(frac * n)), replace=False)
    y_new = y_np.copy()
    y_new[idx] = (y_np[idx] + rng.integers(1, num_classes, size=idx.shape[0])
                  ) % num_classes
    mask = np.zeros(n, dtype=bool)
    mask[idx] = True
    return torch.from_numpy(y_new), torch.from_numpy(mask)


def make_token_batch(generator: torch.Generator, batch: int, seq_len: int,
                     vocab: int):
    """Synthetic LM batch: (tokens, labels), (batch, seq_len) int32 each,
    labels the stream shifted by one (labels[:, i] = tokens[:, i + 1]).
    The stream is drawn from `generator` (on its own device), where the
    JAX package draws from a `jax.random` key: the two packages give
    different tokens for one seed."""
    toks = torch.randint(0, vocab, (batch, seq_len + 1), generator=generator,
                         dtype=torch.int64, device=generator.device)
    toks = toks.to(torch.int32)
    return toks[:, :-1], toks[:, 1:]
