"""Fault tolerance: heartbeats, straggler detection, failure injection and
retries.

The port of ``repro.ft.monitor`` (plain Python, as the reference's).

At 1000+ nodes the interesting failures are partial: one slow chip (thermal
throttling, ECC retries), one dead host, one hung collective. The pieces:

- ``Heartbeat``: per-worker liveness registry with timeout -> dead-set.
- ``StragglerDetector``: rolling step-time stats; flags outliers beyond
  ``threshold`` x median. The cross-worker median is maintained
  *incrementally* (two-heap rolling median with lazy deletion), so a
  fleet-scale monitor pays O(log W) per step instead of re-sorting every
  buffered sample. Mitigations are pluggable; the thermal tie-in
  (repro_torch.control.LutController over core/runtime.py) BOOSTS the hot
  chip's rail (performance-preserving, the paper's knob in reverse) before
  resorting to rebalancing — ``repro_torch.control.MonitorTelemetry``
  routes the events into the control plane.
- ``retry_step``: bounded-retry wrapper around a train step for transient
  failures, with checkpoint-restore escalation.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


class Heartbeat:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.last_seen: Dict[str, float] = {}

    def beat(self, worker: str, t: Optional[float] = None):
        self.last_seen[worker] = time.time() if t is None else t

    def dead(self, now: Optional[float] = None) -> Set[str]:
        now = time.time() if now is None else now
        return {w for w, t in self.last_seen.items()
                if now - t > self.timeout_s}

    def alive(self, now: Optional[float] = None) -> Set[str]:
        return set(self.last_seen) - self.dead(now)


@dataclass
class StragglerEvent:
    worker: str
    step: int
    step_time: float
    median: float
    ratio: float


class _RollingMedian:
    """Two-heap median over a multiset with O(log n) add/remove.

    ``lo`` is a max-heap (negated) holding the smallest ``n // 2`` values;
    ``hi`` is a min-heap holding the rest, so ``hi[0]`` is the *upper*
    median ``sorted(values)[n // 2]`` — the exact statistic the legacy
    sort-everything implementation reported.

    Removals are lazy with *per-heap* tombstones: a removal is attributed
    to the heap that provably holds an instance of the value (``v`` is in
    ``lo`` iff ``v <= max(lo)``, since the heaps partition the sorted
    order), and the tombstone is consumed only when a copy surfaces at
    *that* heap's top.  A single shared tombstone map would let the other
    heap's prune consume it when duplicates straddle the lo/hi boundary,
    desynchronizing the logical sizes.
    """

    def __init__(self):
        self._lo: List[float] = []  # max-heap via negation
        self._hi: List[float] = []  # min-heap
        self._lo_n = 0  # logical (live) sizes
        self._hi_n = 0
        self._dead_lo: Dict[float, int] = {}
        self._dead_hi: Dict[float, int] = {}

    def __len__(self) -> int:
        return self._lo_n + self._hi_n

    def _prune_lo(self):
        while self._lo and self._dead_lo.get(-self._lo[0], 0):
            v = -heapq.heappop(self._lo)
            self._dead_lo[v] -= 1
            if not self._dead_lo[v]:
                del self._dead_lo[v]

    def _prune_hi(self):
        while self._hi and self._dead_hi.get(self._hi[0], 0):
            v = heapq.heappop(self._hi)
            self._dead_hi[v] -= 1
            if not self._dead_hi[v]:
                del self._dead_hi[v]

    def _rebalance(self):
        want_lo = len(self) // 2
        while self._lo_n > want_lo:
            self._prune_lo()
            v = -heapq.heappop(self._lo)
            self._lo_n -= 1
            heapq.heappush(self._hi, v)
            self._hi_n += 1
        while self._lo_n < want_lo:
            self._prune_hi()
            v = heapq.heappop(self._hi)
            self._hi_n -= 1
            heapq.heappush(self._lo, -v)
            self._lo_n += 1

    def add(self, v: float):
        self._prune_lo()
        if self._lo and v <= -self._lo[0]:
            heapq.heappush(self._lo, -v)
            self._lo_n += 1
        else:
            heapq.heappush(self._hi, v)
            self._hi_n += 1
        self._rebalance()

    def remove(self, v: float):
        """Remove one instance of ``v`` (must be present)."""
        self._prune_lo()
        if self._lo and v <= -self._lo[0]:  # an instance lives in lo
            self._dead_lo[v] = self._dead_lo.get(v, 0) + 1
            self._lo_n -= 1
        else:
            self._dead_hi[v] = self._dead_hi.get(v, 0) + 1
            self._hi_n -= 1
        self._rebalance()

    @property
    def median(self) -> float:
        self._prune_hi()
        return self._hi[0]


class StragglerDetector:
    def __init__(self, threshold: float = 1.5, window: int = 32,
                 min_samples: int = 8):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self.times: Dict[str, deque] = {}
        self.events: List[StragglerEvent] = []
        self._median = _RollingMedian()

    def record(self, worker: str, step: int, step_time: float):
        dq = self.times.setdefault(worker, deque(maxlen=self.window))
        if len(dq) == self.window:  # deque is full: append evicts dq[0]
            self._median.remove(dq[0])
        dq.append(step_time)
        self._median.add(step_time)
        if len(self._median) < self.min_samples:
            return None
        median = self._median.median
        if step_time > self.threshold * median:
            ev = StragglerEvent(worker, step, step_time, median,
                                step_time / median)
            self.events.append(ev)
            return ev
        return None


class TransientError(RuntimeError):
    pass


def retry_step(fn: Callable, *args, max_retries: int = 3,
               on_failure: Optional[Callable[[int, Exception], None]] = None,
               **kw):
    """Run ``fn`` with bounded retries on TransientError; re-raise otherwise."""
    for attempt in range(max_retries + 1):
        try:
            return fn(*args, **kw)
        except TransientError as e:  # noqa: PERF203
            if on_failure:
                on_failure(attempt, e)
            if attempt == max_retries:
                raise
    raise AssertionError("unreachable")


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: fail step k once."""
    fail_at: Set[int] = field(default_factory=set)
    seen: Set[int] = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise TransientError(f"injected failure at step {step}")
