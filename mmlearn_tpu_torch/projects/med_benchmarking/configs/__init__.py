"""The med_benchmarking configs, counterpart of
``projects.med_benchmarking.configs``: importing the package registers the
datasets; ``experiment/baseline.yaml`` and
``experiment/zeroshot_classification_eval.yaml`` are found through the
searchpath ``pkg://mmlearn_tpu_torch.projects.med_benchmarking.configs``."""

import mmlearn_tpu_torch.projects.med_benchmarking.datasets  # noqa: F401
