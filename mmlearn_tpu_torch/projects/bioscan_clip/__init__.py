"""BIOSCAN-CLIP: images, DNA barcodes and taxonomy text, contrastively,
counterpart of the root ``projects.bioscan_clip``.

Importing the package registers the ``dna`` modality (the JAX project
registers it when its dataset module is imported). Its dataset (HDF5) and
the recipe's config composition wait for the port's config layer.
"""

from mmlearn_tpu_torch.datasets.core.modalities import Modalities

if not Modalities.has_modality("dna"):
    Modalities.register_modality("dna")
