# Port of repro/serving/engine.py: the same engine on torch; the cache is preallocated and written in place.
"""Batched inference engine: prefill + decode loop over the Model API.

This is the per-replica execution engine that SynergAI schedules.  One
``InferenceEngine`` corresponds to one deployed "inference engine" in the
paper's terminology: (architecture x serving configuration) on one worker.

Where the JAX engine donates the cache buffers to each decode step, the
port preallocates the decode-sized cache once per ``generate`` and every
decode step writes its token (for RWKV, its recurrent state) into it in
place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.models.registry import Model
from repro_torch.serving import sampling
from repro_torch.serving.kvcache import cache_bytes, pad_cache


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    batches: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class InferenceEngine:
    """Greedy/stochastic batched generation with a persistent KV cache."""

    def __init__(self, model: Model, params, max_len: int = 256,
                 sampler: Callable = sampling.greedy):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.sampler = sampler
        self.stats = EngineStats()

    def generate(self, batch: dict, n_tokens: int, generator=None):
        """batch: {"tokens": [B, S] int} on the model's device, and for a
        VLM ``"vision_embeds"`` [B, n_vision_tokens, D] (an encoder-decoder
        model: ``"audio_embeds"`` [B, S_src, D]) in the model's dtype, which
        goes to ``prefill`` with the tokens; the cross caches are sized to
        S_src.  Returns tokens [B, n_tokens] (int32)."""
        tokens = batch["tokens"]
        B, prompt_len = tokens.shape
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(self.params, batch)
        ctx_len = (batch["audio_embeds"].shape[1]
                   if "audio_embeds" in batch else None)
        caches = pad_cache(caches, self.model.init_cache(B, self.max_len,
                                                         ctx_len))
        _sync(logits)
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_tokens += B * prompt_len

        t0 = time.perf_counter()
        outs = []
        tok = self.sampler(logits, generator)
        for i in range(n_tokens):
            outs.append(tok)
            if i == n_tokens - 1:
                break
            step = {"token": tok[:, None], "pos": prompt_len + i}
            logits, caches = self.model.decode(self.params, caches, step)
            tok = self.sampler(logits, generator)
        _sync(tok)
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decoded_tokens += B * n_tokens
        self.stats.batches += 1
        return torch.stack(outs, dim=1)

    def cache_footprint(self, B: int) -> int:
        return cache_bytes(self.model.init_cache(B, self.max_len,
                                                 device="meta"))
