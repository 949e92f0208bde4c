"""LibriSpeech audio+text dataset.

A counterpart of :mod:`mmlearn_tpu.datasets.builtin.librispeech`: the same
examples, key for key, from the same files.

Parity: the original mmlearn's mmlearn/datasets/librispeech.py — audio/transcript
pairs with ``pad_or_trim`` to 30 s @ 16 kHz (reference lines 20-55,107-121).
Walks the standard LibriSpeech layout
(``<root>/<split>/<speaker>/<chapter>/*.flac`` + ``*.trans.txt``); audio
decoding uses ``soundfile`` if available (gated import — torchaudio is not a
dependency of this framework).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from mmlearn_tpu_torch.conf import store
from mmlearn_tpu_torch.constants import EXAMPLE_INDEX_KEY
from mmlearn_tpu_torch.datasets.core.example import Example
from mmlearn_tpu_torch.datasets.processors.transforms import pad_or_trim

SAMPLE_RATE = 16000
CLIP_SECONDS = 30


@store(group="datasets", name="LibriSpeech", populate_full_signature=False)
class LibriSpeech:
    """LibriSpeech loader emitting (audio, text) Examples."""

    def __init__(self, root_dir: Optional[str] = None, split: str = "train-clean-100") -> None:
        root_dir = root_dir or os.environ.get("LIBRISPEECH_ROOT_DIR")
        if root_dir is None:
            raise ValueError(
                "LibriSpeech requires root_dir (or $LIBRISPEECH_ROOT_DIR)"
            )
        base = os.path.join(root_dir, split)
        if not os.path.isdir(base):
            raise FileNotFoundError(f"LibriSpeech split not found: {base}")
        self.entries: list[tuple[str, str]] = []
        for trans in sorted(
            glob.glob(os.path.join(base, "*", "*", "*.trans.txt"))
        ):
            chapter_dir = os.path.dirname(trans)
            with open(trans) as f:
                for line in f:
                    utt_id, _, text = line.partition(" ")
                    flac = os.path.join(chapter_dir, f"{utt_id}.flac")
                    if os.path.isfile(flac):
                        self.entries.append((flac, text.strip()))

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def _load_audio(path: str) -> np.ndarray:
        try:
            import soundfile as sf
        except ImportError as err:  # pragma: no cover
            raise ImportError(
                "LibriSpeech audio decoding requires the 'soundfile' package"
            ) from err
        audio, rate = sf.read(path, dtype="float32")
        if rate != SAMPLE_RATE:
            # linear resample to 16 kHz
            n_out = int(len(audio) * SAMPLE_RATE / rate)
            audio = np.interp(
                np.linspace(0, len(audio) - 1, n_out),
                np.arange(len(audio)),
                audio,
            ).astype(np.float32)
        return audio

    def __getitem__(self, idx: int) -> Example:
        path, text = self.entries[idx]
        audio = self._load_audio(path)
        audio = pad_or_trim(audio, SAMPLE_RATE * CLIP_SECONDS)
        return Example(
            {
                "audio": audio[:, None],  # (T, 1) channel-last
                "text": text,
                EXAMPLE_INDEX_KEY: idx,
            }
        )
