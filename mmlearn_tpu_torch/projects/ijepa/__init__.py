"""The I-JEPA project: ViT-S/16 I-JEPA pretraining on ImageNet-1k."""
