"""``paddle.io`` of the port: datasets, samplers and ``DataLoader``."""
from .dataloader import (BatchSampler, ChainDataset, ComposeDataset,  # noqa: F401
                         DataLoader, Dataset, DistributedBatchSampler,
                         IterableDataset, RandomSampler, Sampler,
                         SequenceSampler, Subset, TensorDataset,
                         WeightedRandomSampler, WorkerInfo,
                         default_collate_fn, get_worker_info, random_split)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "DataLoader",
           "Dataset", "DistributedBatchSampler", "IterableDataset",
           "RandomSampler", "Sampler", "SequenceSampler", "Subset",
           "TensorDataset", "WeightedRandomSampler", "WorkerInfo",
           "default_collate_fn", "get_worker_info", "random_split"]
