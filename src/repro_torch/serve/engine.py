"""Batched serving engine: prefill-by-decode, then greedy decode, with a
shared KV cache (the twin of ``repro/serve/engine.py``).

A static batch with ragged prompt lengths: every step feeds one token per
sequence at one position; a prompt shorter than the longest repeats its
last token, as in the reference. The model runs eagerly (the reference
``jax.jit``s its decode step; a CUDA graph of the step is later work),
and the cache tensors are updated in place. The cache's dtype is the
engine's own (float32 by default, as in the reference) whatever the
model's: the decode-attention op takes the two types.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from repro_torch.models.lm import LanguageModel


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


class ServeEngine:
    def __init__(self, model: LanguageModel, cache_len: int = 256,
                 cache_dtype: torch.dtype = torch.float32):
        self.model = model
        self.cache_len = cache_len
        self.cache_dtype = cache_dtype

    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Request]:
        """Run a static batch of requests to completion (greedy)."""
        model = self.model
        dev = model.device
        b = len(requests)
        cache = model.init_cache(b, self.cache_len, dtype=self.cache_dtype)
        max_prompt = max(len(r.prompt) for r in requests)
        # prompt tokens of every step, uploaded once: (max_prompt, B)
        prompts = torch.tensor(
            [[r.prompt[min(t, len(r.prompt) - 1)] for r in requests]
             for t in range(max_prompt)], dtype=torch.int32, device=dev)
        last_logits = None
        for t in range(max_prompt):
            last_logits, cache = model.decode_step(
                prompts[t], cache,
                torch.full((b,), t, dtype=torch.int32, device=dev))
        # decode; argmax takes the first of equal maxima, as jnp.argmax
        pos = max_prompt
        cur = torch.argmax(last_logits, dim=-1)
        steps = max(r.max_new_tokens for r in requests)
        for s in range(steps):
            for i, tok in enumerate(cur.tolist()):
                if not requests[i].done:
                    requests[i].out_tokens.append(int(tok))
            logits, cache = model.decode_step(
                cur, cache,
                torch.full((b,), pos + s, dtype=torch.int32, device=dev))
            cur = torch.argmax(logits, dim=-1)
        return requests
