"""The BIOSCAN-CLIP configs, counterpart of ``projects.bioscan_clip.configs``:
importing the package registers ``BIOSCANInsectDataset`` (``datasets``),
``DNAProcessor`` (``datasets/tokenizers``), ``BarcodeBERT``
(``modules/encoders``) and ``TaxonomicClassification`` (``eval_task``);
``experiment/bioscan_1m.yaml`` is found through the searchpath
``pkg://mmlearn_tpu_torch.projects.bioscan_clip.configs``. LoRA is
configured through the task's ``peft_configs``."""

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.projects.bioscan_clip.dataset import BIOSCANInsectDataset
from mmlearn_tpu_torch.projects.bioscan_clip.dna_tokenizer import DNAProcessor
from mmlearn_tpu_torch.projects.bioscan_clip.encoders import BarcodeBERT
from mmlearn_tpu_torch.projects.bioscan_clip.eval_task import TaxonomicClassification  # noqa: F401

external_store(group="datasets", name="BIOSCANInsectDataset",
               populate_full_signature=False)(BIOSCANInsectDataset)
external_store(group="datasets/tokenizers", name="DNAProcessor",
               populate_full_signature=False)(DNAProcessor)
external_store(group="modules/encoders", name="BarcodeBERT",
               populate_full_signature=False)(BarcodeBERT)
