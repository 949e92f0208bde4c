"""Core data abstractions of the port: modalities, examples, collation,
samplers, the host loader and the device feeder, and the TFRecord and
streaming readers."""

from mmlearn_tpu_torch.datasets.core.combined_dataset import CombinedDataset
from mmlearn_tpu_torch.datasets.core.data_collator import (
    DefaultDataCollator,
    collate_example_list,
)
from mmlearn_tpu_torch.datasets.core.example import Example, find_matching_indices
from mmlearn_tpu_torch.datasets.core.loader import DataLoader, DeviceFeeder
from mmlearn_tpu_torch.datasets.core.modalities import Modalities, Modality
from mmlearn_tpu_torch.datasets.core.samplers import (
    CombinedDatasetRatioSampler,
    DistributedEvalSampler,
    RandomSampler,
    SequentialSampler,
)
from mmlearn_tpu_torch.datasets.core.streaming import StreamingDataset, jsonl_open_shard
from mmlearn_tpu_torch.datasets.core.tfrecord import TFRecordDataset, tfrecord_open_shard

__all__ = [
    "CombinedDataset",
    "CombinedDatasetRatioSampler",
    "DataLoader",
    "DefaultDataCollator",
    "DeviceFeeder",
    "DistributedEvalSampler",
    "Example",
    "Modalities",
    "Modality",
    "RandomSampler",
    "SequentialSampler",
    "StreamingDataset",
    "TFRecordDataset",
    "jsonl_open_shard",
    "tfrecord_open_shard",
    "collate_example_list",
    "find_matching_indices",
]
