"""Deterministic shard sampler with torch ``DistributedSampler`` parity.

The port's own copy of tpu_ddp/data/sampler.py (numpy only). The
reference shards CIFAR-10 with ``DistributedSampler(num_replicas=ws,
rank=rank, shuffle=False, drop_last=False)`` (part2/part2b/main.py:78-79):
base order ``range(n)`` (or a ``seed + epoch`` permutation when
shuffling), padded to ``ceil(n/ws)*ws`` by wrapping from the start, and
rank r takes ``indices[r::ws]``.
"""

from __future__ import annotations

import math

import numpy as np


class DistributedShardSampler:
    def __init__(
        self,
        dataset_len: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} out of range [0, {num_replicas})")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_len % num_replicas:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch reshuffle hook (reference part2/part2b/main.py:189)."""
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        return self.indices_and_valid()[0]

    def indices_and_valid(self) -> tuple[np.ndarray, np.ndarray]:
        """(this rank's indices, bool mask that is False exactly on the
        wrap-padding duplicates)."""
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(self.dataset_len)
        else:
            idx = np.arange(self.dataset_len)
        if not self.drop_last and len(idx) < self.total_size:
            pad = self.total_size - len(idx)
            reps = math.ceil(pad / len(idx))
            idx = np.concatenate([idx, np.tile(idx, reps)[:pad]])
        else:
            idx = idx[: self.total_size]
        valid = np.arange(self.total_size) < self.dataset_len
        return (idx[self.rank :: self.num_replicas],
                valid[self.rank :: self.num_replicas])

    def __iter__(self):
        return iter(self.indices())

    def __len__(self) -> int:
        return self.num_samples
