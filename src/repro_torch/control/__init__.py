"""repro_torch.control — the telemetry -> controller -> actuator control
plane of the port (the reference's ``repro.control``):

    sensors ──> TelemetryBus ──> Snapshot ──> Controller ──> Actions
       ^                                          │
       └── FleetActuator.settle (thermal) <───────┘──> EngineActuator

    from repro_torch import control as ctl
    from repro_torch.core.runtime import EnergyAwareRuntime

    rt = EnergyAwareRuntime(prof, policy="power_save")   # the CUDA card
    controller = ctl.LutController(rt.planner, sweep=(10.0, 45.0, 8))
    fleet = ctl.FleetActuator.from_runtime(rt)
    loop = ctl.ControlLoop(
        ctl.TelemetryBus([ctl.AmbientSensor(trace), fleet]),
        controller, [fleet])
    report = loop.step(now)

The planner's fixed points and the actuator's thermal settle run on the
runtime's device; telemetry, the RailField lookups, the controller,
admission pricing, the §9 fault model (``faults``) and the §10 fleet
health machine (``fleet``: a ``FleetLoop`` over one ``PodDomain`` per pod)
are host-side numpy, as in the reference.
"""
from repro_torch.control.actuator import (Actuator, EngineActuator,
                                          FleetActuator, FleetReadout)
from repro_torch.control.admission import (AdmissionController,
                                           AdmissionStats)
from repro_torch.control.controller import (Action, BoostRail, Controller,
                                            ControllerStats, LutController,
                                            Preempt, RailBackoff, Rebalance,
                                            Restore, SafeState, SetRails,
                                            Throttle)
from repro_torch.control.faults import ChaosTelemetry, ControlFaultModel
from repro_torch.control.fleet import (DEGRADED, DRAINED, HEALTHY,
                                       QUARANTINED, FanoutTelemetry,
                                       FleetLoop, FleetReport, PodDomain,
                                       PodPlanner, PodRailChannel,
                                       PodTelemetryView, TickContext)
from repro_torch.control.loop import ControlLoop, LoopReport
from repro_torch.control.lut import (DEFAULT_UTIL_KNOTS, DynamicLut,
                                     RailField, sweep_points)
from repro_torch.control.planner import FleetPlanner, PlanOut
from repro_torch.control.telemetry import (AmbientSample, AmbientSensor,
                                           ChipTempSample, EngineTelemetry,
                                           HeartbeatSample, MonitorTelemetry,
                                           SafeStateSample, SdcSample,
                                           Snapshot, StepSample,
                                           StragglerSample, TelemetryBus,
                                           TelemetrySource, TickSample,
                                           UtilSample)

__all__ = [
    # telemetry
    "TelemetrySource", "TelemetryBus", "Snapshot",
    "AmbientSensor", "EngineTelemetry", "MonitorTelemetry",
    "AmbientSample", "ChipTempSample", "StepSample", "TickSample",
    "UtilSample", "StragglerSample", "HeartbeatSample", "SdcSample",
    "SafeStateSample",
    # fault containment (§9)
    "ControlFaultModel", "ChaosTelemetry",
    # fleet failure domains (§10)
    "FleetLoop", "FleetReport", "PodDomain", "PodRailChannel",
    "PodPlanner", "TickContext", "FanoutTelemetry", "PodTelemetryView",
    "HEALTHY", "DEGRADED", "QUARANTINED", "DRAINED",
    # decisions
    "Controller", "LutController", "ControllerStats",
    "AdmissionController", "AdmissionStats",
    "Action", "SetRails", "BoostRail", "Rebalance", "Throttle",
    "RailBackoff", "Restore", "SafeState", "Preempt",
    # actuation
    "Actuator", "FleetActuator", "EngineActuator", "FleetReadout",
    # planning + loop
    "FleetPlanner", "PlanOut", "DynamicLut", "RailField", "sweep_points",
    "DEFAULT_UTIL_KNOTS", "ControlLoop", "LoopReport",
]
