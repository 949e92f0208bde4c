"""ImageNet dataset wrapper with the CLIP zero-shot evaluation protocol.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.imagenet`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/imagenet.py — an ImageFolder-style
loader (implemented natively: sorted class-dir walk, no torchvision), optional
mask generator (reference lines 66-68), and the zero-shot classification
protocol metadata: the standard 80 CLIP prompt templates (reference lines
70-156) plus ``id2label``. Class names load from a ``classnames.json``/
``id2label.json`` file in the root (or ``IMAGENET_ID2LABEL`` env path) and
fall back to folder names — the reference embeds the 1000-name table inline.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.builtin.image_utils import (
    ImageTransform,
    load_image,
    to_model_dtype,
)
from mmlearn_tpu_torch.datasets.core.example import Example

import logging

logger = logging.getLogger(__name__)

# The standard CLIP ImageNet prompt-template set (OpenAI CLIP; the reference
# embeds the same list at imagenet.py:70-156).
ZERO_SHOT_PROMPT_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.",
    "the embroidered {}.", "a photo of a hard to see {}.",
    "a bright photo of a {}.", "a photo of a clean {}.",
    "a photo of a dirty {}.", "a dark photo of the {}.",
    "a drawing of a {}.", "a photo of my {}.", "the plastic {}.",
    "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.",
    "a photo of the dirty {}.", "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.", "a photo of the {}.",
    "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.",
    "the origami {}.", "the {} in a video game.", "a sketch of a {}.",
    "a doodle of the {}.", "a origami {}.",
    "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.",
    "a photo of a nice {}.", "a photo of a weird {}.",
    "a blurry photo of a {}.", "a cartoon {}.", "art of a {}.",
    "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.",
    "a photo of the small {}.", "a photo of the weird {}.",
    "the cartoon {}.", "art of the {}.", "a drawing of the {}.",
    "a photo of the large {}.", "a black and white photo of a {}.",
    "the plushie {}.", "a dark photo of a {}.", "itap of a {}.",
    "graffiti of the {}.", "a toy {}.", "itap of my {}.",
    "a photo of a cool {}.", "a photo of a small {}.", "a tattoo of the {}.",
]

_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tiff")


@store(group="datasets", name="ImageNet", populate_full_signature=False)
class ImageNet:
    """ImageFolder-style ImageNet loader with zero-shot metadata."""

    zero_shot_prompt_templates = ZERO_SHOT_PROMPT_TEMPLATES

    def __init__(
        self,
        root_dir: Optional[str] = None,
        split: str = "train",
        transform: Optional[Callable] = None,
        mask_generator: Optional[Any] = None,
        image_size: int = 224,
        manifest_cache: bool = False,
    ) -> None:
        root_dir = root_dir or os.environ.get("IMAGENET_ROOT_DIR")
        if root_dir is None:
            raise ValueError(
                "ImageNet requires root_dir (or $IMAGENET_ROOT_DIR)"
            )
        self.root = os.path.join(root_dir, split)
        if not os.path.isdir(self.root):
            raise FileNotFoundError(f"ImageNet split dir not found: {self.root}")
        self.transform = transform or ImageTransform(size=image_size)
        self.mask_generator = mask_generator

        # opt-in manifest cache: the ~1.3M-file directory walk is seconds on
        # local disk but MINUTES per process on network mounts (gcsfuse on
        # TPU VMs, NFS on SLURM). The first scan persists a manifest beside
        # the split dir; later constructions (every host, every restart)
        # read one file. Delete `.mmlearn_manifest.json` after changing the
        # dataset on disk.
        manifest_path = os.path.join(self.root, ".mmlearn_manifest.json")
        classes, rel_samples = None, None
        if manifest_cache and os.path.isfile(manifest_path):
            try:
                with open(manifest_path) as f:
                    payload = json.load(f)
                classes = list(payload["classes"])
                rel_samples = [(str(p), int(i)) for p, i in payload["samples"]]
            except (OSError, ValueError, KeyError) as err:
                logger.warning(
                    "Ignoring unreadable manifest %s (%s) — rescanning",
                    manifest_path, err,
                )
                classes = rel_samples = None
        if classes is None:
            classes = sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))
            )
            class_to_idx = {c: i for i, c in enumerate(classes)}
            rel_samples = []
            for cls in classes:
                cdir = os.path.join(self.root, cls)
                for fname in sorted(os.listdir(cdir)):
                    if fname.lower().endswith(_IMG_EXTENSIONS):
                        rel_samples.append(
                            (os.path.join(cls, fname), class_to_idx[cls])
                        )
            if manifest_cache:
                self._write_manifest(manifest_path, classes, rel_samples)
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = [
            (os.path.join(self.root, rel), idx) for rel, idx in rel_samples
        ]

        self.id2label = self._load_id2label(root_dir, classes)

    @staticmethod
    def _write_manifest(path: str, classes: list, samples: list) -> None:
        """Atomic best-effort write (read-only mounts just skip caching);
        process-race-safe: concurrent writers produce identical content and
        os.replace is atomic."""
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"classes": classes, "samples": samples}, f)
            os.replace(tmp, path)
            logger.info("Wrote dataset manifest %s (%d files)", path, len(samples))
        except OSError as err:
            logger.warning("Could not write manifest %s: %s", path, err)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @staticmethod
    def _load_id2label(root_dir: str, classes: list[str]) -> dict[int, str]:
        for candidate in (
            os.environ.get("IMAGENET_ID2LABEL"),
            os.path.join(root_dir, "id2label.json"),
            os.path.join(root_dir, "classnames.json"),
        ):
            if candidate and os.path.isfile(candidate):
                with open(candidate) as f:
                    raw = json.load(f)
                if isinstance(raw, list):
                    return {i: name for i, name in enumerate(raw)}
                try:
                    return {int(k): v for k, v in raw.items()}
                except ValueError:
                    # wnid-keyed form ({"n01440764": "tench", ...}): map
                    # through the class-folder order
                    return {
                        i: raw.get(c, c) for i, c in enumerate(classes)
                    }
        if len(classes) == 1000:
            # self-contained 1000-class mapping (the reference embeds the
            # same table, mmlearn/datasets/imagenet.py:157+); folder names
            # are wnids, so map them through the canonical index order
            from mmlearn_tpu_torch.datasets.builtin._imagenet_labels import (
                IMAGENET_ID2LABEL,
            )

            return dict(IMAGENET_ID2LABEL)
        return {i: c for i, c in enumerate(classes)}

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Example:
        path, target = self.samples[idx]
        if path.lower().endswith((".jpg", ".jpeg")):
            # fused native decode+resize on the eval path (PIL fallback inside)
            from mmlearn_tpu_torch.datasets.builtin.image_utils import (
                decode_transform_jpeg,
            )

            with open(path, "rb") as f:
                img = decode_transform_jpeg(f.read(), self.transform)
        else:
            img = self.transform(load_image(path))
        example = Example(
            {
                "rgb": to_model_dtype(img),
                "rgb_target": target,
                EXAMPLE_INDEX_KEY: idx,
            }
        )
        if self.mask_generator is not None:
            mask = self.mask_generator()
            example["rgb_mask"] = np.asarray(mask)
        return example
