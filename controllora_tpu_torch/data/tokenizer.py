"""CLIP text tokenization.

The port's own copy of ``controllora_tpu/data/tokenizer.py`` (numpy only):
the port imports nothing of the JAX package. tests/test_torch_standalone.py
holds the two equal.

The reference uses HF CLIPTokenizer (reference train_text_to_image_control_lora.py:400).
This container has no network and no vocab assets, so two implementations:

  * `CLIPBPETokenizer` — a complete byte-level BPE tokenizer with CLIP's conventions
    (lowercase, whitespace fold, `</w>` word suffix, <|startoftext|>/<|endoftext|>
    specials, 77-token padding). Point it at a standard `vocab.json` + `merges.txt`
    (or the original gzip merges file) to get exact CLIP ids.
  * `HashTokenizer` — deterministic hash-based ids for training/tests without vocab
    assets; NOT CLIP-compatible, but stable across runs (enough for the fill50k smoke
    workload and benchmarks).
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP conventions; model_max_length 77 with BOS/EOS + EOS-pad
    (matching CLIPTokenizer(padding='max_length', truncation=True) as the reference
    calls it, train:575-580)."""

    # Canonical CLIP pre-tokenizer (openai/CLIP simple_tokenizer; HF CLIPTokenizer
    # `self.pat`). \p{L}/\p{N} need the `regex` module; without it, an ASCII
    # approximation (splits runs of non-ASCII letters differently — fine for the
    # hermetic HashTokenizer-era workloads, wrong for accented prompts).
    try:
        import regex as _regex

        PAT = _regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            _regex.IGNORECASE,
        )
    except ImportError:  # pragma: no cover - regex is installed in this container
        PAT = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def __init__(self, vocab: Dict[str, int], merges: List[tuple], max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.max_length = max_length
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]

    # ------------------------------------------------------------------ loading

    @classmethod
    def from_files(
        cls, vocab_json: Optional[str] = None, merges_txt: Optional[str] = None
    ) -> "CLIPBPETokenizer":
        if merges_txt is None:
            raise FileNotFoundError("merges file required")
        if merges_txt.endswith(".gz"):
            with gzip.open(merges_txt, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1]]
        else:
            with open(merges_txt, encoding="utf-8") as f:
                lines = [l for l in f.read().split("\n") if l and not l.startswith("#")]
            merges = [tuple(l.split()) for l in lines]
        if vocab_json is not None:
            with open(vocab_json, encoding="utf-8") as f:
                vocab = json.load(f)
        else:
            # rebuild the vocab exactly as openai/CLIP does from the merges list
            vocab_list = list(bytes_to_unicode().values())
            vocab_list = vocab_list + [v + "</w>" for v in vocab_list]
            for m in merges:
                vocab_list.append("".join(m))
            vocab_list.extend(["<|startoftext|>", "<|endoftext|>"])
            vocab = {v: i for i, v in enumerate(vocab_list)}
        return cls(vocab, merges)

    # ------------------------------------------------------------------ bpe

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts, pad_id: Optional[int] = None) -> np.ndarray:
        """`pad_id`: padding token for positions after EOS — default EOS
        (SD1.5/SD2 CLIPTokenizer convention); SDXL's tokenizer_2 pads with
        '!' = id 0 instead (pass pad_id=0 for the ViT-bigG tower)."""
        if isinstance(texts, str):
            texts = [texts]
        pad = self.eos if pad_id is None else pad_id
        out = np.full((len(texts), self.max_length), pad, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode_text(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in tokenizer (no vocab assets needed).

    Words map to stable pseudo-ids via blake2; good enough for smoke training where the
    text pathway only needs to be *consistent*, not CLIP-compatible."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = 49406 % vocab_size
        self.eos = 49407 % vocab_size

    def encode_text(self, text: str) -> List[int]:
        words = whitespace_clean(text).lower().split(" ")
        ids = []
        for w in words:
            h = int.from_bytes(hashlib.blake2b(w.encode(), digest_size=4).digest(), "big")
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts, pad_id: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        pad = self.eos if pad_id is None else pad_id
        out = np.full((len(texts), self.max_length), pad, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode_text(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def default_tokenizer(assets_dir: Optional[str] = None, require_clip: bool = False):
    """Real CLIP BPE if vocab assets exist (looked up in assets_dir or $CLIP_VOCAB_DIR),
    else the hash fallback.

    require_clip: set when the caller runs real SD1.5 weights — text embeddings from
    non-CLIP ids would silently garbage-condition every sample, so falling back to
    HashTokenizer must be an error, not a default (reference consumes the real
    CLIPTokenizer at train_text_to_image_control_lora.py:400).
    """
    cand = assets_dir or os.environ.get("CLIP_VOCAB_DIR")
    if cand:
        merges = None
        for name in ("merges.txt", "bpe_simple_vocab_16e6.txt.gz"):
            p = os.path.join(cand, name)
            if os.path.exists(p):
                merges = p
                break
        if merges:
            vocab = os.path.join(cand, "vocab.json")
            return CLIPBPETokenizer.from_files(
                vocab if os.path.exists(vocab) else None, merges
            )
        if require_clip:
            raise FileNotFoundError(
                f"CLIP vocab assets not found in {cand!r} (need merges.txt or "
                "bpe_simple_vocab_16e6.txt.gz). Refusing to hash-tokenize against "
                "pretrained CLIP weights."
            )
    if require_clip:
        raise FileNotFoundError(
            "Pretrained SD1.5 weights are in use but no CLIP vocab assets were found. "
            "Set $CLIP_VOCAB_DIR (or pass assets_dir) to a directory containing "
            "vocab.json + merges.txt; HashTokenizer ids are NOT CLIP ids and would "
            "garbage-condition every sample."
        )
    import warnings

    warnings.warn(
        "default_tokenizer: no CLIP vocab assets; using HashTokenizer (hermetic ids, "
        "NOT CLIP-compatible). Fine for smoke/bench runs only.",
        stacklevel=2,
    )
    return HashTokenizer()
