"""Batch-key constants, a copy of :mod:`mmlearn_tpu.constants` (the port
imports nothing of the JAX package)."""

#: key of an example's index within its dataset
EXAMPLE_INDEX_KEY = "example_index"

#: suffix of a modality's per-example presence mask in a collated batch
MODALITY_PRESENCE_SUFFIX = "_presence"

#: key of the index of the sub-dataset an example came from
DATASET_INDEX_KEY = "dataset_index"
