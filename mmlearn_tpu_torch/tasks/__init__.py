"""Tasks of the port."""

from mmlearn_tpu_torch.tasks.contrastive_pretraining import (
    ContrastivePretraining,
    ModuleKeySpec,
)
from mmlearn_tpu_torch.tasks.ijepa import IJEPA

__all__ = ["ContrastivePretraining", "IJEPA", "ModuleKeySpec"]
