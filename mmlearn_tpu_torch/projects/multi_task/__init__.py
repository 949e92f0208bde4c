"""The multi-task project: rgb<->depth contrastive pretraining with an
I-JEPA auxiliary task on the shared rgb tower."""
