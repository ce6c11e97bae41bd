"""Batches with background prefetch (counterpart of
`promonet_tpu/data/loader.py`)

A thread pool loads the sampled batches, `num_workers` at a time and at
most `prefetch` ahead of the consumer, while the card steps. A
training item is cropped with numpy.random.default_rng((RANDOM_SEED,
epoch, index)), so a crop depends only on the epoch and the item, as in
the JAX package.
"""
import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import config as config_module
from .collate import collate
from .dataset import Dataset
from .sampler import Sampler


class Loader:
    """Iterates over the batches of one epoch (`sampler.set_epoch`)"""

    def __init__(self, dataset, partition, num_workers=None, prefetch=2,
                 config=None):
        self.config = config_module.default() if config is None else config
        self.dataset = dataset
        self.partition = partition
        self.train = partition.startswith('train')
        self.sampler = Sampler(len(dataset), partition, self.config)
        self.num_workers = (
            self.config.NUM_WORKERS if num_workers is None else num_workers)
        self.prefetch = prefetch

    def _load_batch(self, indices, epoch):
        items = []
        for index in indices:
            if self.train:
                rng = np.random.default_rng(
                    (self.config.RANDOM_SEED, epoch, index))
                items.append(self.dataset.load_item(index, chunk_rng=rng))
            else:
                items.append(self.dataset[index])
        return collate(items, pad_to_bucket=not self.train, config=self.config)

    def __iter__(self):
        epoch = self.sampler.epoch
        batches = list(self.sampler)
        if not batches:
            return
        out = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    remaining = iter(batches)
                    pending = collections.deque()
                    while True:
                        while len(pending) < self.num_workers + self.prefetch:
                            indices = next(remaining, None)
                            if indices is None:
                                break
                            pending.append(pool.submit(
                                self._load_batch, indices, epoch))
                        if not pending or stop.is_set():
                            for future in pending:
                                future.cancel()
                            break
                        out.put(pending.popleft().result())
                out.put(None)
            except BaseException as error:
                out.put(error)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # Unblock a producer waiting on a full queue
            while thread.is_alive():
                try:
                    out.get(timeout=0.1)
                except queue.Empty:
                    pass

    def __len__(self):
        return len(self.sampler)


def loader(dataset, partition, config=None, native=False):
    """A `Loader` over one partition of a dataset"""
    config = config_module.default() if config is None else config
    return Loader(
        Dataset(dataset, partition, config, native=native), partition,
        config=config)
