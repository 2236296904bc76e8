"""Hash token ids (77 a prompt): words hash to stable ids with blake2b, BOS and EOS
around them, padded with EOS or with 0. Stands in for the CLIP BPE vocabulary, which
is a download; the number of ids, and so the text encoders' work, is the same."""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

VOCAB = 49408
LENGTH = 77
BOS, EOS = 49406, 49407


def word_ids(text: str) -> list:
    words = re.sub(r"\s+", " ", text).strip().lower().split(" ")
    return [int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "big")
            % (VOCAB - 2) for w in words]


def token_ids(texts: Sequence[str], pad: int = EOS) -> np.ndarray:
    out = np.full((len(texts), LENGTH), pad, dtype=np.int64)
    for i, t in enumerate(texts):
        ids = [BOS] + word_ids(t)[: LENGTH - 2] + [EOS]
        out[i, : len(ids)] = ids
    return out
