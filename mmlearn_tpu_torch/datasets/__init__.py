"""The port's data layer: core abstractions (examples, collation, samplers,
the host loader and the device feeder), processors and synthetic datasets."""

from mmlearn_tpu_torch.datasets.core import (
    CombinedDataset,
    DataLoader,
    DefaultDataCollator,
    DeviceFeeder,
    Example,
    Modalities,
)

__all__ = [
    "CombinedDataset",
    "DataLoader",
    "DefaultDataCollator",
    "DeviceFeeder",
    "Example",
    "Modalities",
]
