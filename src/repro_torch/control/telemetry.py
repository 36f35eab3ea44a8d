"""Telemetry samples (the counterpart of the reference's
``control/telemetry.py``). Only ``TickSample``, which the serving engine
emits every tick, is ported so far; the bus and the other samples wait for
the control-plane slice."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TickSample:
    """One serve-engine scheduler tick.  ``slots`` (total cache slots) lets
    the snapshot derive a load fraction — the utilization axis of the
    RailField fast path; 0 means the producer predates the field."""
    tick: int
    queued: int
    active: int
    finished: int
    tokens: int
    tick_s: float
    slots: int = 0
    admitted: int = 0      # requests admitted this tick
    oldest_wait: float = 0.0  # ticks the oldest queued request has waited
    # actual free KV pages (paged allocator free list); -1 = producer
    # predates page telemetry, admission pricing ignores the bound
    pages_free: int = -1
