from mmlearn_tpu_torch.modules.losses.contrastive import (
    ContrastiveLoss,
    LossPairSpec,
    masked_infonce,
    masked_infonce_chunked,
)
from mmlearn_tpu_torch.modules.losses.data2vec import Data2VecLoss, smooth_l1

__all__ = ["ContrastiveLoss", "Data2VecLoss", "LossPairSpec", "masked_infonce",
           "masked_infonce_chunked", "smooth_l1"]
