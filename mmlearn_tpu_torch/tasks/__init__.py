"""Tasks of the port."""

from mmlearn_tpu_torch.tasks.contrastive_pretraining import (
    ContrastivePretraining,
    ModuleKeySpec,
)

__all__ = ["ContrastivePretraining", "ModuleKeySpec"]
