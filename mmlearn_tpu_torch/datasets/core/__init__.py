"""Core data abstractions of the port."""

from mmlearn_tpu_torch.datasets.core.modalities import Modalities, Modality

__all__ = ["Modalities", "Modality"]
