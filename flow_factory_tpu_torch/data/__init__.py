from .dataset import GeneralDataset, PreprocessedDataset, compute_fingerprint, load_raw_records
from .loader import MultiReplicaLoader, SequentialLoader, collate, get_dataloader
from .sampler import (
    BaseKRepeatSampler,
    DistributedKRepeatSampler,
    GroupContiguousSampler,
    GroupDistributedSampler,
    get_data_sampler,
)

__all__ = [
    "GeneralDataset",
    "PreprocessedDataset",
    "compute_fingerprint",
    "load_raw_records",
    "MultiReplicaLoader",
    "SequentialLoader",
    "collate",
    "get_dataloader",
    "BaseKRepeatSampler",
    "DistributedKRepeatSampler",
    "GroupContiguousSampler",
    "GroupDistributedSampler",
    "get_data_sampler",
]
