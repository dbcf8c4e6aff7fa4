"""Aspect-ratio bucket batch sampler; port of the AspectRatioBatchSampler
of pixart_sigma_tpu/data/sampler.py (the balanced and per-process samplers
wait for multi-process training)."""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence


class AspectRatioBatchSampler:
    """Groups dataset indices into full batches of one ratio bucket."""

    def __init__(self, dataset, batch_size: int, aspect_ratios: Dict[str, Sequence[float]],
                 drop_last: bool = True, valid_num: int = 0, shuffle: bool = True,
                 seed: int = 0, ratio_nums: Optional[Dict[float, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.aspect_ratios = aspect_ratios
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        ratio_nums = ratio_nums or getattr(dataset, "ratio_nums", None)
        if ratio_nums:
            self.valid_keys = {str(k) for k, v in ratio_nums.items() if v >= valid_num}
        else:
            self.valid_keys = set(aspect_ratios.keys())

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self) -> Iterator[List[int]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        buckets: Dict[str, List[int]] = {k: [] for k in self.aspect_ratios}
        for idx in order:
            info = self.dataset.get_data_info(idx)
            ratio = info["height"] / info["width"]
            key = min(self.aspect_ratios.keys(), key=lambda r: abs(float(r) - ratio))
            if key not in self.valid_keys:
                continue
            bucket = buckets[key]
            bucket.append(idx)
            if len(bucket) == self.batch_size:
                yield bucket[:]
                bucket.clear()
        if not self.drop_last:
            for bucket in buckets.values():
                if bucket:
                    yield bucket[:]

    def __len__(self) -> int:
        return max(1, len(self.dataset) // self.batch_size)  # full batches, a lower bound


class SimpleBatchSampler:
    """Shuffled full batches for single-scale datasets (the JAX trainer's
    `_SimpleBatchSampler`)."""

    def __init__(self, n: int, batch_size: int, seed: int = 0, dataset=None):
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.dataset = dataset

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.dataset is not None and hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self) -> Iterator[List[int]]:
        order = list(range(self.n))
        random.Random(self.seed + self.epoch).shuffle(order)
        for i in range(0, self.n - self.batch_size + 1, self.batch_size):
            yield order[i:i + self.batch_size]

    def __len__(self) -> int:
        return max(1, self.n // self.batch_size)
