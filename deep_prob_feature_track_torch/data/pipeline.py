"""Host-side batching: collate, a prefetching batch loader, the copy to the
device.

Counterpart of ``deep_prob_feature_track_tpu/data/pipeline.py``:
``BatchLoader`` visits the same indices in the same order (the same
shuffle stream, ``drop_last``, wrap padding flagged in ``pad_mask``,
shards) and loads items on one prefetch thread, so a dataset's own draws
(``TUM``'s keyframe gaps) come in index order.  :func:`to_device` moves a
batch's arrays to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch


def collate(items: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of item dicts into one batch dict (numpy)."""
    batch: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.floating, np.integer)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals  # e.g. the 'name' metadata dicts
    return batch


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch with its arrays as tensors on ``device``: copied from
    pinned memory without blocking the host when ``device`` is a card.
    ``pad_mask`` and non-array entries (the ``name`` lists) stay on the
    host as they are."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        if key == "pad_mask" or not isinstance(value, np.ndarray):
            out[key] = value
        elif device.type == "cuda":
            out[key] = torch.from_numpy(value).pin_memory().to(device, non_blocking=True)
        else:
            out[key] = torch.from_numpy(value).to(device)
    return out


class BatchLoader:
    """Iterates a dataset in batches with optional shuffling and prefetch.

    :param dataset: any object with __len__/__getitem__ returning dicts
    :param drop_last: drop the trailing incomplete batch; the default keeps
        it and pads it by wrapping to the loader's start (static shapes),
        flagging the extra items in 'pad_mask'
    :param prefetch: batches loaded ahead on the prefetch thread (0: load on
        the caller's thread)
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index :: self.num_shards]
        return idx

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        n = len(idx)
        for start in range(0, n, self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    return
                pad = self.batch_size - len(chunk)
                n_real = len(chunk)
                # wrap-pad; np.resize repeats indices when the dataset is
                # smaller than the pad itself
                chunk = np.concatenate([chunk, np.resize(idx, pad)])
                mask = np.concatenate([np.ones(n_real), np.zeros(pad)]).astype(bool)
            else:
                mask = np.ones(self.batch_size, dtype=bool)
            items = [self.dataset[int(i)] for i in chunk]
            batch = collate(items)
            batch["pad_mask"] = mask
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: List[BaseException] = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
                    if stop.is_set():
                        return
            except BaseException as e:  # raised on the caller's thread below
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    break
                yield b
        finally:
            # a caller that stops early: unblock the worker's put, let it
            # finish the batch it is loading, and join it
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
