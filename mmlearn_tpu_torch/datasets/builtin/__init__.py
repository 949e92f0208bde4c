"""Built-in datasets of the port (the synthetic ones; the readers of files
on disk wait for ROADMAP P13b)."""

from mmlearn_tpu_torch.datasets.builtin.synthetic import SyntheticImages, SyntheticImageText

__all__ = ["SyntheticImageText", "SyntheticImages"]
