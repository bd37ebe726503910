"""Prefetching data loader.

Counterpart of ``openseg3d_tpu/data/loader.py`` with
``parallel/mesh.process_shard_indices`` (``mesh.py:112-135``) copied in: a
spawned process pool voxelizes and pads samples ahead of the device, and the
epoch+seed shuffle is deterministic. One process until the multi-GPU slice
(ROADMAP A10): world size 1, rank 0. ``tests/test_torch_data.py`` holds the
index order and ``sample_valid`` equal to the original's.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Iterator

import numpy as np

from .batch import collate_padded

_worker_dataset = None


def process_shard_indices(n: int, shuffle_seed: int | None, epoch: int,
                          batch_size_global: int, world: int = 1, rank: int = 0,
                          return_valid: bool = False):
    """This process's sample indices: epoch+seed deterministic shuffle, padded
    to a multiple of the global batch by cycling from the front, strided by
    rank (the DistributedSampler analog). With return_valid, also a bool
    array marking which slots are real samples (False = a padding duplicate),
    so that eval can keep recycled frames out of the IoU histogram."""
    idx = np.arange(n)
    if shuffle_seed is not None:
        rng = np.random.RandomState(shuffle_seed + epoch)
        rng.shuffle(idx)
    per_host_batch = batch_size_global // world
    total = int(np.ceil(n / batch_size_global)) * batch_size_global
    valid = np.concatenate([np.ones(n, bool), np.zeros(total - n, bool)])
    idx = np.resize(idx, total)
    sel = np.arange(total).reshape(-1, world, per_host_batch)[:, rank, :].reshape(-1)
    if return_valid:
        return idx[sel], valid[sel]
    return idx[sel]


def _init_worker(dataset_factory, seed, worker_offset):
    global _worker_dataset
    ident = mp.current_process()._identity
    wid = ident[0] if ident else 0
    if seed is not None:
        np.random.seed(seed + worker_offset + wid)
    _worker_dataset = dataset_factory()


def _load_one(index):
    return _worker_dataset.load_padded(index)[0]


class DataLoader:
    """Iterates padded, collated [B, cap, ...] numpy batches.

    dataset_factory: zero-arg callable building the dataset (pickled to
    workers). num_workers=0 runs inline (useful for tests).
    """

    def __init__(self, dataset_factory, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int | None = None,
                 drop_last: bool = True):
        self.dataset_factory = dataset_factory
        self.dataset = dataset_factory()
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._pool = None
        if num_workers > 0:
            # spawn, not fork: the parent holds CUDA and torch's threads, whose
            # locks a forked child would inherit mid-flight. Spawned workers
            # start fresh and run numpy code only; dataset_factory must pickle
            # (functools.partial, not a lambda).
            ctx = mp.get_context('spawn')
            self._pool = ctx.Pool(num_workers, initializer=_init_worker,
                                  initargs=(dataset_factory, seed, 1000))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        total = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return max(total, 1)

    def __iter__(self) -> Iterator[dict]:
        idx, valid = process_shard_indices(
            len(self.dataset), (self.seed if self.shuffle else None),
            self.epoch, self.batch_size, return_valid=True)
        n_batches = len(self)
        idx = idx[:n_batches * self.batch_size]
        valid = valid[:n_batches * self.batch_size]
        batches = idx.reshape(-1, self.batch_size)
        # With drop_last=False the epoch is padded by recycling samples;
        # sample_valid marks the recycled slots so eval can exclude them from
        # the IoU histogram (they'd otherwise be double counted).
        valids = valid.reshape(-1, self.batch_size)

        def _finish(batch, bvalid):
            if not self.drop_last:
                batch['sample_valid'] = np.asarray(bvalid, bool)
            return batch

        if self._pool is None:
            for b, v in zip(batches, valids):
                yield _finish(collate_padded(
                    [self.dataset.load_padded(i)[0] for i in b]), v)
        else:
            # pipeline: keep 2 batches in flight
            pending = []
            for b, v in zip(batches, valids):
                pending.append((self._pool.map_async(_load_one, list(b)), v))
                if len(pending) >= 3:
                    job, pv = pending.pop(0)
                    yield _finish(collate_padded(job.get()), pv)
            while pending:
                job, pv = pending.pop(0)
                yield _finish(collate_padded(job.get()), pv)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
