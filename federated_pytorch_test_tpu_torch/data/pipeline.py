"""K-client sharding, biased normalization constants, lockstep batching.

Counterpart of the JAX package's `data/pipeline.py`:

* the train set is split into K disjoint contiguous index ranges
  (`client_splits`), truncated to the smallest so the stack is
  rectangular;
* with `biased_input`, clients normalize with different (mean, std):
  (.5,.5), (.3,.4), (.6,.5), cycled for K>3;
* every client evaluates on the full test set under its own
  normalization.

Host arrays stay numpy (uint8 NHWC); the trainer moves them to its device
once and normalizes there (`normalize`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from .cifar import DataSource

# Per-client (mean, std), cycled for K>3 (channels share one value).
BIASED_STATS = ((0.5, 0.5), (0.3, 0.4), (0.6, 0.5))
UNBIASED_STAT = (0.5, 0.5)


def client_splits(n: int, k: int) -> Tuple[Tuple[int, int], ...]:
    """K disjoint contiguous [start, end) ranges covering [0, n)."""
    bounds = [n * i // k for i in range(k + 1)]
    return tuple((bounds[i], bounds[i + 1]) for i in range(k))


def client_stats(k: int, biased: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-client normalization constants, shaped [K] (scalar per client)."""
    if biased:
        stats = [BIASED_STATS[i % len(BIASED_STATS)] for i in range(k)]
    else:
        stats = [UNBIASED_STAT] * k
    means = np.asarray([m for m, _ in stats], np.float32)
    stds = np.asarray([s for _, s in stats], np.float32)
    return means, stds


def normalize(images_u8: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """`(x/255 - mean)/std` in float32.

    `mean`/`std` align with the LEADING axes of `images_u8 [..., H, W, C]`
    — e.g. `[K]` per-client stats against a `[K, B, H, W, C]` batch. They
    are reshaped to `[K, 1, 1, 1, 1]` so they can never broadcast against
    the trailing channel axis (K == C == 3 in the flagship configuration).
    """
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images_u8.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images_u8.device)
    if mean.ndim:
        mean = mean.reshape(mean.shape + (1,) * (images_u8.ndim - mean.ndim))
    if std.ndim:
        std = std.reshape(std.shape + (1,) * (images_u8.ndim - std.ndim))
    x = images_u8.to(torch.float32) / 255.0
    return (x - mean) / std


@dataclasses.dataclass
class FederatedDataset:
    """Host-side federated view of a `DataSource` for K clients.

    train_images: [K, n, 32, 32, 3] uint8 (disjoint shards)
    test_images:  [M, 32, 32, 3] uint8 (shared)
    mean/std: [K] float32 per-client normalization scalars
    """

    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    mean: np.ndarray
    std: np.ndarray
    num_classes: int

    @property
    def n_clients(self) -> int:
        return self.train_images.shape[0]

    @property
    def shard_size(self) -> int:
        return self.train_images.shape[1]

    def steps_per_epoch(self, batch: int) -> int:
        return self.shard_size // batch

    def test_batches(self, batch: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Full-test-set sweep in `[B]` batches (shared across clients; the
        tail is padded by repeating the last sample, with a validity mask)."""
        m = self.test_images.shape[0]
        for start in range(0, m, batch):
            idx = np.arange(start, min(start + batch, m))
            pad = batch - idx.size
            mask = np.concatenate([np.ones(idx.size, bool), np.zeros(pad, bool)])
            if pad:
                idx = np.concatenate([idx, np.full(pad, m - 1)])
            yield self.test_images[idx], self.test_labels[idx], mask


def make_federated(source: DataSource, n_clients: int, biased: bool = True) -> FederatedDataset:
    """Shard a `DataSource` across K clients with per-client normalization."""
    splits = client_splits(source.train_images.shape[0], n_clients)
    n_min = min(e - s for s, e in splits)
    tr_i = np.stack([source.train_images[s : s + n_min] for s, _ in splits])
    tr_l = np.stack([source.train_labels[s : s + n_min].astype(np.int32) for s, _ in splits])
    mean, std = client_stats(n_clients, biased)
    return FederatedDataset(
        train_images=tr_i,
        train_labels=tr_l,
        test_images=source.test_images,
        test_labels=source.test_labels.astype(np.int32),
        mean=mean,
        std=std,
        num_classes=source.num_classes,
    )
