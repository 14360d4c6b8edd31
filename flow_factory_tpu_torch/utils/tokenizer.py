"""Tokenizer loading with a deterministic offline fallback.

Port of ``flow_factory_tpu/utils/tokenizer.py``. The reference gets
tokenizers from the wrapped HF pipeline
(``src/flow_factory/models/abc.py:229-325`` discovery). Here adapters load
HF tokenizers from the local model path when present; in weightless/dev
environments (no downloaded assets) they fall back to :class:`HashTokenizer`
— a deterministic whitespace tokenizer that keeps the full pipeline runnable
and seed-stable for tests.
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np


class HashTokenizer:
    """Deterministic stand-in tokenizer: id = sha1(word) % usable_vocab."""

    def __init__(
        self,
        vocab_size: int = 1000,
        max_length: int = 77,
        bos_token_id: Optional[int] = None,
        eos_token_id: int = 2,
        pad_token_id: int = 0,
    ):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id

    def _word_range(self):
        """[lo, hi) of the ids words map to: above every special id, as the
        JAX package does, or — where the specials sit at the top of the
        vocabulary (CLIP: bos 49406, eos 49407 of 49408) and the JAX
        package's range is empty — the widest gap between special ids."""
        reserved = sorted({self.eos_token_id, self.pad_token_id, self.bos_token_id or 0})
        if reserved[-1] + 1 < self.vocab_size:
            return reserved[-1] + 1, self.vocab_size
        bounds = [-1] + reserved
        a, b = max(zip(bounds, bounds[1:]), key=lambda ab: ab[1] - ab[0])
        if b - a < 2:
            raise ValueError(f"Special token ids {reserved} leave no ids in vocab_size {self.vocab_size}")
        return a + 1, b

    def _word_id(self, word: str) -> int:
        h = int(hashlib.sha1(word.encode()).hexdigest(), 16)
        lo, hi = self._word_range()
        return lo + h % (hi - lo)

    def __call__(
        self,
        text,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str = "np",
        **_,
    ):
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        ids = np.full((len(text), max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(text), max_length), dtype=np.int32)
        for i, t in enumerate(text):
            toks: List[int] = []
            if self.bos_token_id is not None:
                toks.append(self.bos_token_id)
            toks += [self._word_id(w) for w in t.lower().split()]
            toks = toks[: max_length - 1] + [self.eos_token_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def batch_decode(self, ids, **_) -> List[str]:
        return [f"<ids:{','.join(str(int(i)) for i in row if int(i) != self.pad_token_id)}>" for row in ids]


def load_tokenizer(
    model_path: str,
    subfolder: str,
    vocab_size: int,
    max_length: int,
    eos_token_id: int = 2,
    bos_token_id: Optional[int] = None,
    pad_token_id: int = 0,
):
    """HF tokenizer from a local path, else :class:`HashTokenizer`."""
    path = os.path.join(model_path, subfolder) if model_path else ""
    if path and os.path.isdir(path):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(path)
        except Exception:  # pragma: no cover - depends on local assets
            pass
    return HashTokenizer(
        vocab_size=vocab_size,
        max_length=max_length,
        eos_token_id=eos_token_id,
        bos_token_id=bos_token_id,
        pad_token_id=pad_token_id,
    )
