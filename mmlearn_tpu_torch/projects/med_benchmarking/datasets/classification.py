"""The med_benchmarking classification datasets, counterpart of
``projects.med_benchmarking.datasets.classification``: ``BACH``, ``PCAM``
and ``NckCrc`` from the HuggingFace hub (the ``datasets`` package);
``LC25000`` from its per-organ ``save_to_disk`` caches (``datasets``);
``SICAP`` from its xlsx partitions, the one-hot grade columns reduced by
``idxmax`` (pandas and ``openpyxl``, imported by this reader alone);
``HAM10000`` and ``PadUfes20`` from a CSV and an image directory;
``MedMNISTPlus`` from ``<name>_224.npz``. Each keeps its JAX ``id2label``
and ``zero_shot_prompt_templates``; each root comes from ``root_dir`` or
from its environment variable.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from mmlearn_tpu_torch.conf import external_store
from mmlearn_tpu_torch.datasets.builtin.image_utils import load_image
from mmlearn_tpu_torch.datasets.core.example import Example
from mmlearn_tpu_torch.projects.med_benchmarking.datasets.base import (
    DERMATOLOGY_TEMPLATES,
    HISTOPATHOLOGY_TEMPLATES,
    CSVImageClassification,
    HFImageClassification,
    _MedDatasetBase,
)
from mmlearn_tpu_torch.projects.med_benchmarking.datasets.image_text import _env_root


@external_store(group="datasets", name="BACH", populate_full_signature=False)
class BACH(HFImageClassification):
    """BACH breast-cancer histology (hub ``1aurent/BACH``, the seeded 75/25
    split)."""

    hub_name = "1aurent/BACH"
    id2label = {
        0: "breast non-malignant benign tissue",
        1: "breast malignant in-situ carcinoma",
        2: "breast malignant invasive carcinoma",
        3: "breast normal breast tissue",
    }
    zero_shot_prompt_templates = HISTOPATHOLOGY_TEMPLATES

    def __init__(self, root_dir: Optional[str] = None, **kwargs):
        super().__init__(_env_root("BACH_ROOT_DIR", root_dir), **kwargs)


@external_store(group="datasets", name="PCAM", populate_full_signature=False)
class PCAM(HFImageClassification):
    """PatchCamelyon lymph-node patches (hub ``1aurent/PatchCamelyon``, its
    official splits)."""

    hub_name = "1aurent/PatchCamelyon"
    hub_splits = ("train", "validation", "test")
    id2label = {
        0: "lymph node",
        1: "lymph node containing metastatic tumor tissue",
    }
    zero_shot_prompt_templates = HISTOPATHOLOGY_TEMPLATES

    def __init__(self, root_dir: Optional[str] = None, **kwargs):
        super().__init__(_env_root("PCAM_ROOT_DIR", root_dir), **kwargs)


@external_store(group="datasets", name="LC25000", populate_full_signature=False)
class LC25000(_MedDatasetBase):
    """Lung and colon histology from the prepared per-organ cache
    ``<root>/cache/lc25000_{organ}_{split}.arrow`` (a ``save_to_disk``
    directory): the hub's 25k dump mixes both organs, whose label ids do not
    match the per-organ ``id2label``."""

    zero_shot_prompt_templates = HISTOPATHOLOGY_TEMPLATES
    image_key = "image"
    label_key = "label"

    def __init__(
        self,
        root_dir: Optional[str] = None,
        organ: str = "lung",
        split: str = "train",
        transform: Optional[Callable] = None,
        image_size: int = 224,
    ):
        super().__init__(transform, image_size)
        if organ not in ("lung", "colon"):
            raise ValueError(f"organ must be 'lung' or 'colon', got {organ!r}")
        self.organ = organ
        root = _env_root("LC25000_ROOT_DIR", root_dir)
        path = os.path.join(root, f"cache/lc25000_{organ}_{split}.arrow")
        if not os.path.exists(path):
            raise FileNotFoundError(f"LC25000 expects the prepared per-organ cache at {path}")
        try:
            from datasets import load_from_disk
        except ImportError as err:
            raise ImportError("LC25000 reads its cache through the 'datasets' package, which "
                              f"is not installed ({err})") from err

        self.data = load_from_disk(path)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Example:
        entry = self.data[idx]
        return self._example(entry[self.image_key], entry[self.label_key], idx)

    @property
    def id2label(self) -> dict[int, str]:
        if self.organ == "lung":
            return {0: "benign lung", 1: "lung adenocarcinoma",
                    2: "lung squamous cell carcinoma"}
        return {0: "benign colonic tissue", 1: "colon adenocarcinoma"}


@external_store(group="datasets", name="NckCrc", populate_full_signature=False)
class NckCrc(HFImageClassification):
    """NCK-CRC colorectal histology (hub ``DykeF/NCTCRCHE100K``, its official
    splits; the ``BACK`` class dropped, string labels mapped to ids)."""

    hub_name = "DykeF/NCTCRCHE100K"
    hub_splits = ("train", "train_nonorm", "validation")
    exclude_labels = ("BACK",)
    label_mapping = {
        "ADI": 0, "DEB": 1, "LYM": 2, "MUC": 3, "MUS": 4, "NORM": 5,
        "STR": 6, "TUM": 7,
    }
    id2label = {
        0: "adipose",
        1: "debris",
        2: "lymphocytes",
        3: "mucus",
        4: "smooth muscle",
        5: "normal colon mucosa",
        6: "cancer-associated stroma",
        7: "colorectal adenocarcinoma epithelium",
    }
    zero_shot_prompt_templates = HISTOPATHOLOGY_TEMPLATES

    def __init__(self, root_dir: Optional[str] = None, **kwargs):
        super().__init__(_env_root("NCK_CRC_ROOT_DIR", root_dir), **kwargs)


@external_store(group="datasets", name="SICAP", populate_full_signature=False)
class SICAP(_MedDatasetBase):
    """SICAPv2 prostate Gleason grading: the partitions
    ``partition/Test/{Train,Test}.xlsx`` with one-hot NC/G3/G4/G5 columns
    reduced by ``idxmax``, images under ``<root>/<image_dir>``. Reads the
    xlsx through pandas (and ``openpyxl``), imported here only."""

    id2label = {
        0: "benign glands",
        1: "atrophic dense glands",
        2: "cribriform ill-formed fused papillary patterns",
        3: "isolated nest cells without lumen roseting patterns",
    }
    zero_shot_prompt_templates = HISTOPATHOLOGY_TEMPLATES
    _grades = ("NC", "G3", "G4", "G5")

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "test",
        image_dir: str = "images",
        transform: Optional[Callable] = None,
        image_size: int = 224,
    ):
        super().__init__(transform, image_size)
        if split not in ("train", "test"):
            raise ValueError(f"SICAP split must be train/test, got {split!r}")
        root = _env_root("SICAP_ROOT_DIR", root_dir)
        try:
            import pandas as pd
        except ImportError as err:
            raise ImportError("SICAP reads its xlsx partitions through pandas, which is not "
                              f"installed ({err})") from err

        xlsx = os.path.join(root, "partition/Test", "Train.xlsx" if split == "train"
                            else "Test.xlsx")
        df = pd.read_excel(xlsx)[["image_name", *self._grades]]
        grade_to_id = {g: i for i, g in enumerate(self._grades)}
        self.labels = df[list(self._grades)].idxmax(axis=1).map(grade_to_id).values
        self.paths = df["image_name"].values
        self.image_dir = os.path.join(root, image_dir)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Example:
        path = os.path.join(self.image_dir, str(self.paths[idx]))
        return self._example(load_image(path), int(self.labels[idx]), idx)


@external_store(group="datasets", name="HAM10000", populate_full_signature=False)
class HAM10000(CSVImageClassification):
    """HAM10000 dermatoscopy: ``HAM10000_metadata.csv`` (``image_id``,
    ``dx``), images ``images/<image_id>.jpg`` (the ids have no extension)."""

    csv_name = "HAM10000_metadata.csv"
    path_column = "image_id"
    label_column = "dx"
    image_subdir = "images"
    label_names = {
        "nv": 0, "mel": 1, "bkl": 2, "bcc": 3, "akiec": 4, "vasc": 5, "df": 6,
    }
    id2label = {
        0: "Melanocytic Nevi",
        1: "Melanoma",
        2: "Benign Keratosis-like Lesions",
        3: "Basal Cell Carcinoma",
        4: "Actinic Keratoses and Intraepithelial Carcinoma",
        5: "Vascular Lesions",
        6: "Dermatofibroma",
    }
    zero_shot_prompt_templates = DERMATOLOGY_TEMPLATES

    def __init__(self, root_dir: Optional[str] = None, **kwargs):
        super().__init__(_env_root("HAM10000_ROOT_DIR", root_dir), **kwargs)

    def __getitem__(self, idx: int) -> Example:
        path = os.path.join(self.root_dir, self.image_subdir, f"{self.paths[idx]}.jpg")
        return self._example(load_image(path), self.labels[idx], idx)


@external_store(group="datasets", name="PadUfes20", populate_full_signature=False)
class PadUfes20(CSVImageClassification):
    """PAD-UFES-20 clinical skin-lesion photos: ``metadata.csv`` (``img_id``,
    ``diagnostic``) and ``images/``."""

    csv_name = "metadata.csv"
    path_column = "img_id"
    label_column = "diagnostic"
    image_subdir = "images"
    label_names = {"BCC": 0, "MEL": 1, "SCC": 2, "ACK": 3, "NEV": 4, "SEK": 5}
    id2label = {
        0: "Basal Cell Carcinoma",
        1: "Melanoma",
        2: "Squamous Cell Carcinoma",
        3: "Actinic Keratosis",
        4: "Nevus",
        5: "Seborrheic Keratosis",
    }
    zero_shot_prompt_templates = DERMATOLOGY_TEMPLATES

    def __init__(self, root_dir: Optional[str] = None, **kwargs):
        super().__init__(_env_root("PAD_UFES_20_ROOT_DIR", root_dir), **kwargs)


#: the MedMNIST+ sub-datasets' label maps
_MEDMNIST_LABELS: dict[str, dict[int, str]] = {
    "pathmnist": {
        0: "adipose", 1: "background", 2: "debris", 3: "lymphocytes",
        4: "mucus", 5: "smooth muscle", 6: "normal colon mucosa",
        7: "cancer-associated stroma", 8: "colorectal adenocarcinoma epithelium",
    },
    "dermamnist": {
        0: "actinic keratoses and intraepithelial carcinoma",
        1: "basal cell carcinoma", 2: "benign keratosis-like lesions",
        3: "dermatofibroma", 4: "melanoma", 5: "melanocytic nevi",
        6: "vascular lesions",
    },
    "octmnist": {
        0: "choroidal neovascularization", 1: "diabetic macular edema",
        2: "drusen", 3: "normal retina",
    },
    "pneumoniamnist": {0: "normal chest X-ray", 1: "pneumonia"},
    "retinamnist": {
        0: "no diabetic retinopathy", 1: "mild diabetic retinopathy",
        2: "moderate diabetic retinopathy", 3: "severe diabetic retinopathy",
        4: "proliferative diabetic retinopathy",
    },
    "breastmnist": {0: "malignant breast tumor", 1: "normal or benign breast"},
    "bloodmnist": {
        0: "basophil", 1: "eosinophil", 2: "erythroblast",
        3: "immature granulocytes", 4: "lymphocyte", 5: "monocyte",
        6: "neutrophil", 7: "platelet",
    },
    "organamnist": {
        0: "bladder", 1: "femur-left", 2: "femur-right", 3: "heart",
        4: "kidney-left", 5: "kidney-right", 6: "liver", 7: "lung-left",
        8: "lung-right", 9: "pancreas", 10: "spleen",
    },
}


@external_store(group="datasets", name="MedMNISTPlus", populate_full_signature=False)
class MedMNISTPlus(_MedDatasetBase):
    """A MedMNIST+ sub-dataset at 224 px: ``<root>/<name>_224.npz`` with
    ``{split}_images`` and ``{split}_labels``."""

    zero_shot_prompt_templates = ["a medical image of {}.", "an image of {}."]

    def __init__(
        self,
        name: str = "pathmnist",
        root_dir: Optional[str] = None,
        split: str = "train",
        transform: Optional[Callable] = None,
        image_size: int = 224,
    ) -> None:
        super().__init__(transform, image_size)
        root_dir = _env_root("MEDMNISTPLUS_ROOT_DIR", root_dir)
        self.name = name
        data = np.load(os.path.join(root_dir, f"{name}_224.npz"))
        self.images = data[f"{split}_images"]
        self.labels = data[f"{split}_labels"].reshape(-1)

    @property
    def id2label(self) -> dict[int, str]:
        if self.name in _MEDMNIST_LABELS:
            return _MEDMNIST_LABELS[self.name]
        return {int(i): str(i) for i in np.unique(self.labels)}

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Example:
        return self._example(self.images[idx], self.labels[idx], idx)
