"""The med_benchmarking project: medical CLIP pretraining on four
image-text sets and zero-shot classification over ten medical test sets,
counterpart of the root ``projects.med_benchmarking``. Importing it
registers the datasets."""

import mmlearn_tpu_torch.projects.med_benchmarking.datasets  # noqa: F401
