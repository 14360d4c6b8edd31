"""LM caption upsampling (port of ``flow_factory_tpu/models/text_encoders/caption.py``).

FLUX.2 rewrites short prompts through its conditioning LM before encoding
them, and LTX-2's prompt enhancer does the same over Gemma3: the adapter's
own ``LMEncoder`` generates from its tied-embedding logits
(``return_logits``), so the rewrite adds no parameters.

Decoding is greedy over a fixed padded length: every step runs the whole
causal forward, without an attention mask (pad slots are plain causal
positions, as in the JAX loop), and writes each row's argmax at its cursor,
the row's first free slot. The loop is plain Python over the steps on the
device's tensors, the cursor kept on the device, so nothing is read back to
the host until the ids are done. Stopping at ``eos`` and detokenising run
on the host through the adapter's tokenizer.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


@torch.no_grad()
def greedy_generate(lm, ids: torch.Tensor, cursor: torch.Tensor, steps: int) -> torch.Tensor:
    """``ids`` (B, L) padded, ``cursor`` (B,) each row's first free slot:
    ``steps`` greedy tokens written from the cursors on (JAX
    ``_greedy_generate``); a row whose cursor reached L keeps its ids."""
    ids = ids.clone()
    rows = torch.arange(ids.shape[0], device=ids.device)
    L = ids.shape[1]
    for _ in range(steps):
        _, logits = lm(ids, return_logits=True)
        nxt = logits[rows, cursor - 1].argmax(dim=-1).to(ids.dtype)
        in_range = cursor < L
        ids[rows, cursor.clamp(max=L - 1)] = torch.where(in_range, nxt, ids[:, -1])
        cursor = torch.where(in_range, cursor + 1, cursor)
    return ids


class LMCaptionUpsampler:
    """Greedy prompt rewriter over an ``LMEncoder`` and its tokenizer.

    ``template`` wraps each prompt into an instruction; the generated
    continuation, cut at the first ``eos``, becomes the new prompt, and an
    empty one gives back the original. With the offline ``HashTokenizer``
    the new prompt is a deterministic id transcript."""

    def __init__(self, module, tokenizer, template: str = "Rewrite as a detailed image description: {prompt}\n",
                 max_new_tokens: int = 24, max_length: int = 96):
        self.module = module
        self.tokenizer = tokenizer
        self.template = template
        self.max_new_tokens = int(max_new_tokens)
        self.max_length = int(max_length)

    def __call__(self, prompts: Sequence[str]) -> List[str]:
        texts = [self.template.format(prompt=p) for p in prompts]
        enc = self.tokenizer(texts, max_length=self.max_length, padding="max_length", truncation=True,
                             return_tensors="np")
        mask = np.asarray(enc["attention_mask"])
        cursor = mask.sum(axis=1)  # the first pad slot
        dev = next(self.module.parameters()).device
        out = greedy_generate(self.module, torch.as_tensor(np.asarray(enc["input_ids"]), dtype=torch.long, device=dev),
                              torch.as_tensor(cursor, dtype=torch.long, device=dev), self.max_new_tokens).cpu().numpy()
        eos = getattr(self.tokenizer, "eos_token_id", None)
        results: List[str] = []
        for row, start, orig in zip(out, cursor, prompts):
            gen = row[int(start): int(start) + self.max_new_tokens]
            if eos is not None and (gen == eos).any():
                gen = gen[: int(np.argmax(gen == eos))]
            if len(gen) == 0:
                results.append(orig)
                continue
            text = self.tokenizer.batch_decode([gen], skip_special_tokens=True)[0]
            results.append(text.strip() or orig)
        return results
