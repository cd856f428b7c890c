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

    def prompt_rows(self, requests: List[Request]) -> torch.Tensor:
        """The prompt tokens of every prefill step, uploaded once:
        (max_prompt, B) int32 on the model's device; a prompt shorter than
        the longest repeats its last token."""
        max_prompt = max(len(r.prompt) for r in requests)
        return torch.tensor(
            [[r.prompt[min(t, len(r.prompt) - 1)] for r in requests]
             for t in range(max_prompt)], dtype=torch.int32,
            device=self.model.device)

    @torch.inference_mode()
    def run_steps(self, requests: List[Request], prompts: torch.Tensor,
                  cache, start: int, stop: int, logits=None):
        """Steps ``start`` to ``stop - 1`` of a static batch, step ``i`` at
        position ``i``: its tokens are ``prompts[i]`` while there is a
        prompt row, then the last step's argmax (the first of equal
        maxima, as jnp.argmax), which is read on the host into every
        unfinished request's outputs before the step runs. ``logits`` are
        step ``start - 1``'s (none at step 0): with the cache and the
        outputs so far, the whole state between two steps. Returns the
        last step's logits and the cache."""
        model = self.model
        b = len(requests)
        for i in range(start, stop):
            tokens = (prompts[i] if i < len(prompts)
                      else torch.argmax(logits, dim=-1))
            if i >= len(prompts):
                for r, tok in zip(requests, tokens.tolist()):
                    if not r.done:
                        r.out_tokens.append(int(tok))
            logits, cache = model.decode_step(
                tokens, cache,
                torch.full((b,), i, dtype=torch.int32, device=model.device))
        return logits, cache

    @torch.inference_mode()
    def generate(self, requests: List[Request]) -> List[Request]:
        """Run a static batch of requests to completion (greedy)."""
        cache = self.model.init_cache(len(requests), self.cache_len,
                                      dtype=self.cache_dtype)
        prompts = self.prompt_rows(requests)
        steps = max(r.max_new_tokens for r in requests)
        self.run_steps(requests, prompts, cache, 0, len(prompts) + steps)
        return requests
