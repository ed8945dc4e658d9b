"""Datasets over sharded record stores, with weighted multi-corpus sampling
(the port's copy of after_tpu/dataset/dataset.py).

- ``train_test_split_ids``: the fixed train / validation split (seed 42);
- ``SimpleDataset``: one store's records as dicts of arrays;
- ``CombinedDataset``: several stores, each weighted len ** 0.3;
- ``DataLoader``: a weighted-sampling batch iterator whose one background
  thread builds each batch once and queues it.  It counts what the
  training loop waits for: the seconds spent building batches
  (``batch_seconds``, ``batches``) and the batches the consumer asked for
  while the queue was empty (``dry``).

Host side only: the batches are numpy arrays, uploaded by the trainers.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .audio_example import AudioExample
from .store import RecordReader

PREFETCH = 4   # batches the loader's thread builds ahead


def train_test_split_ids(n: int, test_size: float = 0.02,
                         seed: int = 42) -> Dict[str, np.ndarray]:
    """Deterministic split: a permutation of ``n`` from ``seed``, its first
    round(n * test_size) ids (at least one where n > 1) for validation."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_size))) if n > 1 else 0
    return {"validation": np.sort(perm[:n_test]),
            "train": np.sort(perm[n_test:])}


class SimpleDataset:
    """One store's ``split`` ("train" or "validation", or every record
    when None) as dicts of the buffers named in ``keys`` ("metadata" for
    the record's metadata)."""

    def __init__(self, path: str, keys: Sequence[str],
                 split: Optional[str] = None):
        if split not in ("train", "validation", None):
            raise ValueError(f"split {split!r}: 'train', 'validation' or "
                             "None")
        self.reader = RecordReader(path)
        self.buffer_keys = list(keys)
        all_keys = self.reader.keys()
        ids = (range(len(all_keys)) if split is None
               else train_test_split_ids(len(all_keys))[split])
        self.keys = [all_keys[i] for i in ids]

    def __len__(self) -> int:
        return len(self.keys)

    def example_keys(self) -> List[str]:
        return AudioExample(self.reader.get(self.keys[0])).get_keys()

    def add_buffer_keys(self, keys: Sequence[str]) -> None:
        """Read extra record buffers (no second scan of the store)."""
        self.buffer_keys += [k for k in keys if k not in self.buffer_keys]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        ae = AudioExample(self.reader.get(self.keys[i]))
        out = {}
        for k in self.buffer_keys:
            if k == "metadata":
                out[k] = ae.get_metadata()
            elif k in ae:
                out[k] = ae.get(k)
        return out


class CombinedDataset:
    """Several stores, store i weighted len_i ** 0.3 (normalised), so that
    smaller corpora show up more than their size; ``example_weights`` feeds
    the loader."""

    def __init__(self, path_dict: Dict[str, str],
                 keys: Sequence[str] = ("z", "metadata"),
                 config: str = "train"):
        self.names = list(path_dict.keys())
        self.datasets = [SimpleDataset(p, keys=keys, split=config)
                         for p in path_dict.values()]
        lens = np.array([len(d) for d in self.datasets], dtype=np.float64)
        w = lens ** 0.3
        w = w / w.sum()
        # an example's weight: its store's weight over the store's length
        self.example_weights = np.concatenate(
            [np.full(int(n), wi / max(n, 1))
             for n, wi in zip(lens, w)])
        self.example_weights /= self.example_weights.sum()
        self.offsets = np.concatenate([[0], np.cumsum(lens)]).astype(int)

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, i: int) -> Dict[str, Any]:
        d = int(np.searchsorted(self.offsets, i, side="right") - 1)
        item = self.datasets[d][i - self.offsets[d]]
        item = dict(item)
        item.setdefault("metadata", {})
        if isinstance(item["metadata"], dict):
            item["metadata"]["dataset"] = self.names[d]
        return item

    def example_keys(self) -> List[str]:
        return self.datasets[0].example_keys()

    def add_buffer_keys(self, keys: Sequence[str]) -> None:
        for d in self.datasets:
            d.add_buffer_keys(keys)


class DataLoader:
    """Weighted-sampling batch iterator with background prefetch."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Callable[[List[Dict]], Dict],
                 weights: Optional[np.ndarray] = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.weights = weights
        # seeds one RandomState per iterator, so that iterators whose
        # threads run at once never share a stream
        self._seed_rng = np.random.RandomState(seed)
        self.batches = 0            # batches built
        self.batch_seconds = 0.0    # the time spent building them
        self.dry = 0                # batches asked for from an empty queue

    def _draw_indices(self, rng: np.random.RandomState) -> np.ndarray:
        n = len(self.dataset)
        if self.weights is not None:
            return rng.choice(n, self.batch_size, p=self.weights)
        return rng.randint(0, n, self.batch_size)

    def _make_batch(self, rng: np.random.RandomState) -> Dict:
        items = [self.dataset[i] for i in self._draw_indices(rng)]
        return self.collate_fn(items)

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.RandomState(self._seed_rng.randint(0, 2 ** 31 - 1))
        q: queue_mod.Queue = queue_mod.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = self._make_batch(rng)
                except Exception as e:  # data errors reach the consumer
                    q.put(e)
                    return
                self.batch_seconds += time.perf_counter() - t0
                self.batches += 1
                # built once, then the put is retried: building again on a
                # full queue would drop finished batches and advance the
                # rng per drop, so the data would depend on timing
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=1.0)
                        break
                    except queue_mod.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                if q.empty():
                    self.dry += 1
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
