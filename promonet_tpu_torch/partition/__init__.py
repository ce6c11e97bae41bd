from .core import adaptation_partitions, dataset, datasets
