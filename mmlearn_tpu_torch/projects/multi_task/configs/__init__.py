"""Multi-task project configs, counterpart of ``projects.multi_task.configs``:
the ``CLSPooler`` layer and the rgb transform, registered in the store;
``experiment/contrastive_ijepa.yaml`` is found through the searchpath
``pkg://mmlearn_tpu_torch.projects.multi_task.configs``."""

from __future__ import annotations

import torch
from torch import nn

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageTransform,
)


@external_store(group="modules/layers", name="CLSPooler", populate_full_signature=False)
class CLSPooler(nn.Module):
    """Select the CLS (first) token from a sequence output."""

    def __init__(self, cls_index: int = 0) -> None:
        super().__init__()
        self.cls_index = cls_index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.cls_index]


@external_store(group="datasets/transforms", name="multi_task_rgb_transform",
                populate_full_signature=False)
def multi_task_rgb_transform(size: int = 224, train: bool = True) -> ImageTransform:
    return ImageTransform(size=size, mean=IMAGENET_MEAN, std=IMAGENET_STD, train=train)
