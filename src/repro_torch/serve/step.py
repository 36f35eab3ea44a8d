"""Serving steps: prefill and single-token decode, and sampling (the
counterpart of the reference's ``serve/step.py``).

``prefill_step``: (batch) -> (last_logits, cache)
``decode_step``:  (cache, tokens (B,1), pos) -> (logits (B,V), cache)

The model carries its weights and its device; the engine in
``serve/engine.py`` drives the same model methods tick by tick.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(batch):
        logits, cache = model.prefill(batch, max_len=max_len)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(cache, tokens, pos):
        logits, cache = model.decode(tokens, cache, pos)
        return logits[:, 0], cache

    return decode_step


def sample(logits, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B,V) -> tokens (B,). temperature 0 = greedy (argmax over the
    logits as they are); otherwise categorical over ``logits / temperature``
    with the ``top_k`` largest kept, drawn from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
