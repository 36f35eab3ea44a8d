"""Elastic scaling: rebuild the mesh and plan on a change of device count
and restore the parameters onto it, and the control plane's work-migration
actuation (``Rebalance``); the port of ``repro.ft.elastic``.

The flow: a worker dies and the heartbeat reports a smaller alive set;
``choose_mesh_shape`` picks the largest usable (data, model) grid;
:func:`rebuild` makes a ``DeviceMesh`` of that shape over the first
``n_devices`` ranks of the process group and the plan for it; :func:`rescale`
restores the parameters from the latest checkpoint, each leaf placed by
the plan as a ``DTensor`` (``CheckpointManager.restore(...,
shardings=...)``: the checkpoint is mesh-agnostic).

A controller that decides ``Rebalance(chip)`` (rails alone
cannot hold the clock) needs something to actually *move the work*.
:class:`ElasticWorkAssignment` is that something in simulation: a per-chip
work-share vector that a condemn spreads over the healthy chips, and
:class:`ElasticActuator` is the control-plane adapter — it applies
``Rebalance`` actions to the assignment and feeds the resulting shares back
as :class:`~repro_torch.control.telemetry.UtilSample` telemetry, so the
very next control tick plans rails for the *migrated* load (the condemned
chip cools at ~zero utilization; its former share heats its neighbours).
``ElasticWorkAssignment.mesh_hint`` names the (data, model) grid that
:func:`rescale` onto the surviving devices rebuilds.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device
from repro_torch.control.controller import Rebalance, Restore
from repro_torch.control.telemetry import UtilSample
from repro_torch.models import params as pm
from repro_torch.sharding.plan import make_plan


def choose_mesh_shape(n_devices: int, prefer_model: int = 1) -> Tuple[int, int]:
    """Largest (data, model) grid with model | prefer_model preserved."""
    model = prefer_model
    while model > 1 and (n_devices % model or model > n_devices):
        model //= 2
    data = n_devices // model
    return data, model


def rebuild(cfg, n_devices: int, prefer_model: int = 1, device=None):
    """A ``DeviceMesh`` of ``choose_mesh_shape(n_devices, prefer_model)``
    over ranks ``0 .. n_devices - 1`` of the current process group (of the
    device type of ``device``; None: the CUDA card), axes ``("data",
    "model")``, and its plan -> (mesh, plan)."""
    data, model = choose_mesh_shape(n_devices, prefer_model)
    mesh = DeviceMesh(resolve_device(device).type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))
    return mesh, make_plan(cfg, mesh)


def rescale(cfg, ckpt_mgr, model_obj, n_devices: int, prefer_model: int = 1,
            step: Optional[int] = None, device=None):
    """Restore the parameters from a checkpoint onto a rebuilt mesh, each
    leaf a ``DTensor`` placed by the plan's ``param_shardings`` of
    ``model_obj``'s parameter tree -> (mesh, plan, params, restored
    step)."""
    mesh, plan = rebuild(cfg, n_devices, prefer_model, device)
    meta = model_obj.param_meta()
    like = pm.tree_map(lambda m: torch.empty(m.shape, device="meta"), meta)
    params, got = ckpt_mgr.restore(like, step=step,
                                   shardings=plan.param_shardings(meta))
    return mesh, plan, params, got


class ElasticWorkAssignment:
    """Per-chip work shares under condemn/restore.

    ``shares`` starts at 1.0 everywhere (every chip carries its fair
    share) and always sums to ``n_chips``: condemning a chip zeroes its
    share and spreads it proportionally over the healthy chips, so total
    work is conserved while the condemned chip drains.  ``util(load)``
    scales the shares by the sensed pod load — exactly the per-chip
    utilization vector the RailField's second axis interpolates.
    """

    def __init__(self, n_chips: int):
        self.n = int(n_chips)
        self.shares = np.ones(self.n, np.float32)
        self.condemned: set = set()

    def condemn(self, chip: int) -> np.ndarray:
        """Migrate ``chip``'s share onto the healthy chips (no-op for an
        already-condemned or out-of-range chip, or when it is the last
        healthy chip — someone has to do the work)."""
        if (not 0 <= chip < self.n or chip in self.condemned
                or len(self.condemned) >= self.n - 1):
            return self.shares
        moved = float(self.shares[chip])
        self.shares[chip] = 0.0
        healthy = self.shares > 0
        total = float(self.shares[healthy].sum())
        if moved > 0 and total > 0:
            self.shares[healthy] *= (total + moved) / total
        self.condemned.add(chip)
        return self.shares

    def restore(self, chip: int) -> np.ndarray:
        """Re-admit a repaired/cooled chip at the mean healthy share."""
        if chip not in self.condemned:
            return self.shares
        self.condemned.discard(chip)
        healthy = self.shares > 0
        n_healthy = int(healthy.sum())
        mean = float(self.shares[healthy].sum()) / max(n_healthy, 1)
        self.shares[chip] = mean
        self.shares *= self.n / float(self.shares.sum())
        return self.shares

    def util(self, load: float = 1.0) -> np.ndarray:
        """Per-chip utilization at pod load fraction ``load``."""
        return (self.shares * np.float32(load)).astype(np.float32)

    # -- §10 fleet failure domains: pod-slice views ---------------------
    def pod_share(self, lo: int, hi: int) -> float:
        """Fraction of the fleet's work currently assigned to chips
        ``[lo, hi)`` — the ``control.fleet`` power-budget weight (0.0
        while the pod is quarantined/drained, its share having been
        spread over the survivors)."""
        return float(self.shares[lo:hi].sum()) / float(self.shares.sum())

    def condemned_in(self, lo: int, hi: int) -> Tuple[int, ...]:
        """Condemned chips inside a pod slice, sorted — the §10 restore
        worklist a drained pod walks when it rejoins the fleet."""
        return tuple(sorted(c for c in self.condemned if lo <= c < hi))

    def mesh_hint(self, prefer_model: int = 1) -> Tuple[int, int]:
        """The (data, model) grid a real rescale would rebuild onto."""
        return choose_mesh_shape(self.n - len(self.condemned), prefer_model)


class ElasticActuator:
    """Control-plane adapter: consumes ``Rebalance``/``Restore`` actions,
    produces ``UtilSample`` telemetry.

    Implements both control protocols — ``Actuator.apply`` (a ``Rebalance``
    condemns the chip on the assignment) and ``TelemetrySource.poll`` (the
    current shares ride back to the bus), closing the migration loop:
    decide -> condemn -> shares -> next tick's utilization -> rails.
    """

    def __init__(self, assignment: ElasticWorkAssignment):
        self.assignment = assignment
        self.log: List = []

    def apply(self, action) -> bool:
        if isinstance(action, Rebalance):
            self.assignment.condemn(action.chip)
            self.log.append(action)
            return True
        if isinstance(action, Restore):
            self.assignment.restore(action.chip)
            self.log.append(action)
            return True
        return False

    def poll(self, now: float) -> List:
        return [UtilSample(self.assignment.shares.copy())]
