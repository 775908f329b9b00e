# Port of repro/serving/sampling.py: the same policies on torch, a torch.Generator in place of a key.
"""Token sampling policies for the serving engine."""

from __future__ import annotations

import torch


def greedy(logits, generator=None):
    """argmax over the vocabulary; the first index wins a tie."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature(logits, generator, temp=1.0):
    probs = torch.softmax(logits.float() / max(temp, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def top_k(logits, generator, k=40, temp=1.0):
    vals, idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(vals.float() / max(temp, 1e-6), dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)
