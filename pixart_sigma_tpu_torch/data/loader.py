"""Prefetching data loader -> collated numpy batches (threads or processes).

Port of pixart_sigma_tpu/data/loader.py: items are fetched by a thread pool
(numpy releases the GIL for file reads) or, with `use_processes`, a spawn
process pool that holds a pickled copy of the dataset, for datasets whose
per-item Python work holds the GIL; they are collated into stacked arrays
and queued ahead of the consumer, with a fast-forward for resumed runs.
Both yield the same batches.
"""

from __future__ import annotations

import multiprocessing
import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np

_PROC_DS = None


def _proc_init(ds_bytes: bytes) -> None:
    global _PROC_DS
    _PROC_DS = pickle.loads(ds_bytes)


def _proc_fetch(i: int):
    return _PROC_DS[i]


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy fields; collect str fields into lists."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterates (batch_sampler x dataset) with prefetching workers: threads,
    or spawned processes with `use_processes`."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 8, prefetch: int = 4,
                 skip_batches: int = 0, use_processes: bool = False):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.skip_batches = skip_batches
        self.use_processes = use_processes

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _make_pool(self):
        """(executor, fetch function)."""
        if not self.use_processes:
            return ThreadPoolExecutor(self.num_workers), self.dataset.__getitem__
        pool = ProcessPoolExecutor(self.num_workers,
                                   mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_proc_init,
                                   initargs=(pickle.dumps(self.dataset),))
        return pool, _proc_fetch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                pool, fetch = self._make_pool()
                with pool:
                    for i, batch_idx in enumerate(self.batch_sampler):
                        if stop.is_set():
                            return
                        if i < self.skip_batches:
                            continue
                        items = list(pool.map(fetch, batch_idx))
                        while not stop.is_set():
                            try:
                                q.put(collate(items), timeout=1.0)
                                break
                            except queue.Full:
                                continue
            except BaseException as exc:  # propagate to the consumer
                q.put(exc)
                return
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join(timeout=10)
