"""Batch order (counterpart of `promonet_tpu/data/sampler.py`)

Training partitions give BATCH_SIZE indices at a time from a permutation
drawn anew each epoch from numpy.random.default_rng(RANDOM_SEED + epoch),
dropping the last partial batch; other partitions give each index alone,
in order.
"""
import numpy as np

from .. import config as config_module


class Sampler:

    def __init__(self, length, partition, config=None):
        self.config = config_module.default() if config is None else config
        self.length = length
        self.partition = partition
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.partition.startswith('train'):
            rng = np.random.default_rng(self.config.RANDOM_SEED + self.epoch)
            order = rng.permutation(self.length)
            batch = self.config.BATCH_SIZE
            for start in range(0, self.length - batch + 1, batch):
                yield order[start:start + batch].tolist()
        else:
            for index in range(self.length):
                yield [index]

    def __len__(self):
        if self.partition.startswith('train'):
            return self.length // self.config.BATCH_SIZE
        return self.length
