"""The port's data layer: core abstractions (examples, collation, samplers,
the host loaders and the device feeder, TFRecord and streaming readers),
processors, the built-in readers and corpus materialization."""

from mmlearn_tpu_torch.datasets.core import (
    CombinedDataset,
    DataLoader,
    DefaultDataCollator,
    DeviceFeeder,
    Example,
    Modalities,
)
from mmlearn_tpu_torch.datasets.materialize import (
    MaterializedDataset,
    materialize,
)

__all__ = [
    "CombinedDataset",
    "DataLoader",
    "DefaultDataCollator",
    "DeviceFeeder",
    "Example",
    "MaterializedDataset",
    "materialize",
    "Modalities",
]
