"""Continuous-batching tick composition (host side, model-free).

Every engine tick runs ONE fused model step over all slots.  The scheduler's
job is to compose that step from heterogeneous per-slot work:

- a slot mid-prompt contributes its next **chunked-prefill** extend (up to
  ``chunk`` prompt tokens at the slot's own position),
- a slot mid-generation contributes its **decode** token,
- a free slot contributes nothing (``n_valid = 0`` keeps it invisible to the
  attention mask and cache).

The composed :class:`TickPlan` is pure numpy — the engine turns it into one
model step.  The new-token axis is bucketed to ``{1, chunk}`` (prompt
lengths never leak into the step's shapes; ``n_valid`` carries the
raggedness as data).  Copied from the reference's ``serve/scheduler.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class SlotWork:
    """What one slot contributes to the tick (host-side request view)."""
    slot: int
    kind: str            # "prefill" | "decode"
    tokens: np.ndarray   # (k,) int32 — chunk of prompt, or [last_token, ...]
    completes: bool = False  # this chunk feeds the final prompt token
    # real-token count when tokens carries padding (speculative decode pads
    # short draft runs to the fixed verify width so the fused step keeps one
    # compile bucket); None = len(tokens)
    n_valid: Optional[int] = None


@dataclass
class TickPlan:
    """One fused step: tokens (B,S), per-slot pos (B,), n_valid (B,)."""
    tokens: np.ndarray
    pos: np.ndarray
    n_valid: np.ndarray
    work: List[SlotWork] = field(default_factory=list)

    @property
    def width(self) -> int:
        return int(self.tokens.shape[1])


def compose(work: List[SlotWork], pos: np.ndarray, slots: int,
            chunk: int) -> Optional[TickPlan]:
    """Bucket per-slot work into one (B,S) ragged step; None when idle.

    S is ``chunk`` whenever any slot is prefilling (decode rows ride along
    with ``n_valid = 1`` — the mixed prefill/decode batch of
    Sarathi/vLLM-style schedulers), else 1.
    """
    if not work:
        return None
    S = (chunk if any(w.kind == "prefill" for w in work)
         else max(len(w.tokens) for w in work))
    tokens = np.zeros((slots, S), np.int32)
    n_valid = np.zeros(slots, np.int32)
    for w in work:
        k = len(w.tokens)
        tokens[w.slot, :k] = w.tokens
        n_valid[w.slot] = k if w.n_valid is None else w.n_valid
    return TickPlan(tokens=tokens, pos=pos.astype(np.int32).copy(),
                    n_valid=n_valid, work=work)
