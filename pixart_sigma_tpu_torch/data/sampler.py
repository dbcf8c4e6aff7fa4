"""Aspect-ratio bucket batch samplers and the per-rank view of a global one;
port of AspectRatioBatchSampler, BalancedAspectRatioBatchSampler and
ShardedBatchSampler of pixart_sigma_tpu/data/sampler.py."""

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


class BalancedAspectRatioBatchSampler(AspectRatioBatchSampler):
    """Round-robin over the ratio buckets so rare ratios are drawn too.

    A bucket accepts at most its dataset frequency (`ratio_nums`) of items;
    once it yields a batch it waits until every other available bucket has
    yielded; the epoch is padded to len(dataset) // batch_size batches by
    redrawing (refilled, reshuffled) from buckets already seen, from an RNG
    seeded with seed + epoch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ratio_nums = kwargs.get("ratio_nums") or getattr(self.dataset, "ratio_nums", None)

    def __iter__(self) -> Iterator[List[int]]:
        rng = random.Random(self.seed + self.epoch)
        order = list(range(len(self.dataset)))
        if self.shuffle:
            rng.shuffle(order)
        buckets: Dict[str, List[int]] = {k: [] for k in self.aspect_ratios}
        originals: Dict[str, List[int]] = {k: [] for k in self.aspect_ratios}
        counts: Dict[str, int] = {k: 0 for k in self.aspect_ratios}
        quota = {k: (self.ratio_nums or {}).get(float(k), len(order)) for k in self.aspect_ratios}
        available = sorted(self.valid_keys)
        exhausted: List[str] = []
        total_batches = len(order) // self.batch_size
        yielded = 0
        for idx in order:
            info = self.dataset.get_data_info(idx)
            ratio = info["height"] / info["width"]
            key = min(self.aspect_ratios.keys(), key=lambda r: abs(float(r) - ratio))
            if key not in self.valid_keys:
                continue
            if counts[key] < quota[key]:
                counts[key] += 1
                buckets[key].append(idx)
                originals[key].append(idx)
            if not available:
                available, exhausted = exhausted, []
            if key not in available:
                continue
            bucket = buckets[key]
            if len(bucket) >= self.batch_size:
                yield bucket[:self.batch_size]
                del bucket[:self.batch_size]
                yielded += 1
                exhausted.append(key)
                available.remove(key)
        # pad the epoch to the expected batch count from the buckets seen
        refillable = [k for k in self.valid_keys if originals[k]]
        for _ in range(total_batches - yielded):
            if not refillable:
                break
            key = rng.choice(refillable)
            bucket = buckets[key]
            if len(bucket) >= self.batch_size:
                yield bucket[:self.batch_size]
                del bucket[:self.batch_size]
                if not bucket:
                    buckets[key] = originals[key][:]
                    rng.shuffle(buckets[key])
            else:
                buckets[key] = originals[key][:]
                rng.shuffle(buckets[key])


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


class ShardedBatchSampler:
    """One rank's view of a global batch sampler (sharded training).

    Every rank builds the same global batch sequence (same seed, same
    `set_epoch`) from a sampler made at the global batch size, B_local x
    num_replicas, and rank r keeps the contiguous slice
    [r B_local, (r + 1) B_local), so the ranks' slices in rank order are the
    one-rank global batch. A short trailing batch is dropped, so every rank
    steps in lockstep."""

    def __init__(self, global_sampler, local_batch_size: int, num_replicas: int, rank: int):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} of {num_replicas}")
        self.global_sampler = global_sampler
        self.local_batch_size = local_batch_size
        self.num_replicas = num_replicas
        self.rank = rank

    def set_epoch(self, epoch: int) -> None:
        self.global_sampler.set_epoch(epoch)

    def __iter__(self) -> Iterator[List[int]]:
        lo = self.rank * self.local_batch_size
        for batch in self.global_sampler:
            if len(batch) == self.local_batch_size * self.num_replicas:
                yield batch[lo:lo + self.local_batch_size]

    def __len__(self) -> int:
        """The full global batches of this epoch (the wrapped sampler's
        iteration is seeded by (seed, epoch), so this preview is what
        `__iter__` yields)."""
        full = self.local_batch_size * self.num_replicas
        return sum(1 for batch in self.global_sampler if len(batch) == full)
