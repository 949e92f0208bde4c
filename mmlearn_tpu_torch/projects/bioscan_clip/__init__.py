"""BIOSCAN-CLIP: images, DNA barcodes and taxonomy text, contrastively,
counterpart of the root ``projects.bioscan_clip``.

Importing the package registers the ``dna`` modality (the JAX project
registers it when its dataset module is imported). The HDF5 dataset is
``dataset.BIOSCANInsectDataset``; ``configs/experiment/bioscan_1m.yaml``
composes the recipe, which ``recipe.bioscan_task`` also builds in Python.
"""

from mmlearn_tpu_torch.datasets.core.modalities import Modalities

if not Modalities.has_modality("dna"):
    Modalities.register_modality("dna")
