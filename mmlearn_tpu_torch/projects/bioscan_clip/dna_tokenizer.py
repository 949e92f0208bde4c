"""K-mer DNA tokenizer, the port's copy of
``projects.bioscan_clip.dna_tokenizer``.

The barcode is padded with ``N`` or cut to ``max_length``, split into
k-mers with a stride, mapped to a ``[MASK]/[CLS]/[UNK]`` + 4^k vocabulary,
and ``[CLS]`` is put first: a fixed-length int32 array (``1 + (max_length -
k) // stride`` tokens; 133 at the recipe's 660, 5, 5).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

SPECIAL_TOKENS = ("[MASK]", "[CLS]", "[UNK]")


def create_dna_vocab(k: int = 5) -> dict[str, int]:
    kmers = ("".join(p) for p in itertools.product("ACGT", repeat=k))
    return {tok: i for i, tok in enumerate(itertools.chain(SPECIAL_TOKENS, kmers))}


@dataclass
class PadDNASequence:
    """Pad with ``N`` or cut to a fixed length."""

    max_len: int

    def __call__(self, dna_sequence: str) -> str:
        if len(dna_sequence) > self.max_len:
            return dna_sequence[: self.max_len]
        return dna_sequence + "N" * (self.max_len - len(dna_sequence))


@dataclass
class KmerProcessor:
    """Strided k-mer splitting."""

    k: int
    stride: int = 1

    def __call__(self, dna_sequence: str) -> list[str]:
        return [dna_sequence[i : i + self.k]
                for i in range(0, len(dna_sequence) - self.k + 1, self.stride)]


class DNAProcessor:
    """Barcode string to a fixed-length array of token ids."""

    def __init__(self, max_length: int = 660, kmers: int = 5, stride: int = 5) -> None:
        self.vocab = create_dna_vocab(kmers)
        self.padder = PadDNASequence(max_length)
        self.kmer_processor = KmerProcessor(kmers, stride)
        self.cls_id = self.vocab["[CLS]"]
        self.unk_id = self.vocab["[UNK]"]
        self.mask_id = self.vocab["[MASK]"]
        # CLS, then the strided k-mers
        self.seq_length = 1 + (max_length - kmers) // stride + 1

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __call__(self, dna_sequence: str) -> np.ndarray:
        kmers = self.kmer_processor(self.padder(dna_sequence.upper()))
        ids = [self.cls_id] + [self.vocab.get(km, self.unk_id) for km in kmers]
        return np.asarray(ids, dtype=np.int32)
