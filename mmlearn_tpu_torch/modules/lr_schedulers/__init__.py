from mmlearn_tpu_torch.modules.lr_schedulers.linear_warmup_cosine_lr import (
    linear_warmup_cosine_annealing_lr,
    schedule_lambda_lr,
)
from mmlearn_tpu_torch.modules.lr_schedulers.onecycle import onecycle_lr

__all__ = ["linear_warmup_cosine_annealing_lr", "onecycle_lr", "schedule_lambda_lr"]
