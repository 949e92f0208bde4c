"""Host-side batch processors of the port."""

from mmlearn_tpu_torch.datasets.processors.masking import IJEPAMaskGenerator

__all__ = ["IJEPAMaskGenerator"]
