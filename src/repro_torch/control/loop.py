"""ControlLoop — one telemetry -> controller -> actuator tick.

The port of ``repro.control.loop``. The composition root of the control
plane: a :class:`TelemetryBus` of sources, one :class:`Controller`, and a
list of actuators. ``step(now)`` polls, decides, applies every action to
every actuator (each takes the ones it understands), then lets stateful
actuators *settle* (the :class:`FleetActuator` thermal re-evaluation whose
readout feeds the next poll). Reports accumulate in ``history``.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.control.controller import Action, Controller
from repro_torch.control.telemetry import Snapshot, TelemetryBus


@dataclass
class LoopReport:
    now: float
    snapshot: Snapshot
    actions: List[Action]
    readouts: List = field(default_factory=list)
    pod: Optional[int] = None  # which pod ticked (None = single-pod loop)

    @property
    def readout(self):
        """The first settled readout (the fleet one in standard wiring)."""
        return self.readouts[0] if self.readouts else None


class ControlLoop:
    """``tick_deadline_s`` (off by default — replays must stay free of
    wall-clock) arms a *measured* watchdog: a tick whose decide+apply
    exceeds the deadline reports ``note_deadline_miss`` to the controller,
    degrading the NEXT tick.  Deterministic chaos scripts deadline misses
    through the fault model instead."""

    def __init__(self, bus: TelemetryBus, controller: Controller,
                 actuators: Sequence,
                 tick_deadline_s: Optional[float] = None):
        self.bus = bus
        self.controller = controller
        self.actuators = list(actuators)
        self.tick_deadline_s = tick_deadline_s
        self.deadline_misses = 0
        self.history: List[LoopReport] = []
        self._wants_util = "util" in inspect.signature(
            controller.decide).parameters

    def step(self, now: float = 0.0,
             util: Optional[np.ndarray] = None) -> LoopReport:
        t0 = time.monotonic() if self.tick_deadline_s is not None else None
        snap = self.bus.poll(now)
        for act in self.actuators:  # clock write channels before actions
            if hasattr(act, "begin_tick"):
                act.begin_tick(now)
        actions = (self.controller.decide(snap, util=util)
                   if self._wants_util else self.controller.decide(snap))
        for a in actions:
            for act in self.actuators:
                act.apply(a)
        if (t0 is not None
                and time.monotonic() - t0 > self.tick_deadline_s
                and hasattr(self.controller, "note_deadline_miss")):
            self.deadline_misses += 1
            self.controller.note_deadline_miss()
        readouts = [act.settle(snap, util=util) for act in self.actuators
                    if hasattr(act, "settle")]
        rep = LoopReport(now=now, snapshot=snap, actions=list(actions),
                         readouts=readouts)
        self.history.append(rep)
        return rep
