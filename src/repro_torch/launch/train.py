"""The end-to-end training entry point on one card: the port of the
reference's ``launch/train.py``, with its flags.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --steps 50 --energy-policy power_save --checkpoint-dir CKPT

runs on the CUDA card (``--device cpu`` on the CPU): the train step
(``repro_torch.train.step``), the deterministic data pipeline, async
checkpointing with restore (``--resume``), failure injection with bounded
retry of a step's gradients (the optimizer's in-place update runs once),
straggler detection, and the energy runtime reporting the modelled
fleet's saving each logged step.

With ``--energy-policy`` the run closes the loop through
``repro_torch.control``: step times feed the straggler detector, whose
events route through the ``LutController`` (rail boost or rebalance
become policy decisions), and a ``FleetActuator`` applies the rails and
reports the thermal readout each control tick (the modelled 16 x 16 pod's
field, whose 256 cells solve as one direct product). ``--model-parallel``
above 1 needs the SPMD slice of the port, which is not written yet, and
raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch import control as ctl
from repro_torch import policy as pol
from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import runtime as energy_rt
from repro_torch.core import tpu_fleet as TF
from repro_torch.data.pipeline import DataConfig, make_iterator
from repro_torch.ft.elastic import ElasticActuator, ElasticWorkAssignment
from repro_torch.ft.monitor import (FailureInjector, StragglerDetector,
                                    retry_step)
from repro_torch.launch.mesh import PodTopology
from repro_torch.models.model import Model
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step


def build(arch: str, smoke: bool, n_accum: int, device=None, seed: int = 0):
    """-> (cfg, model with random weights from ``seed``, optimizer, the
    train step)."""
    cfg = registry.get(arch)
    if smoke:
        cfg = cfg.reduced()
    model = Model(cfg, device=device).init(seed)
    opt = make_optimizer(cfg, total_steps=10_000)
    return cfg, model, opt, make_train_step(model, opt, n_accum=n_accum)


def _energy_loop(args, device):
    """The paper's technique around the run: the fleet energy controller
    fed by the step profile, the CLI's policy spec as a ``repro.policy``
    Policy, and the telemetry -> controller -> actuator loop over the same
    planner. Straggler workers resolve to pod coordinates through the
    topology, and Rebalance decisions migrate work through the elastic
    assignment, whose shares feed the RailField's utilization axis."""
    prof = TF.StepProfile.from_roofline(
        compute_s=0.7, memory_s=0.4, collective_s=0.15)
    rt = energy_rt.EnergyAwareRuntime(
        prof, policy=pol.from_spec(args.energy_policy), t_amb=args.t_amb,
        device=device)
    straggler = StragglerDetector()
    topo = PodTopology(grid=rt.substrate.grid)
    mon = ctl.MonitorTelemetry(straggler, topology=topo)
    elastic = ElasticActuator(ElasticWorkAssignment(rt.substrate.n_domains))
    controller = rt.controller()  # per-chip RailField fast path
    fleet = ctl.FleetActuator.from_runtime(rt, field=controller.field)
    loop = ctl.ControlLoop(
        ctl.TelemetryBus([ctl.AmbientSensor(args.t_amb), mon, elastic,
                          fleet]),
        controller, [fleet, elastic])
    return straggler, loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--energy-policy", default="off",
                    help="off | power_save | min_energy | overscale:<g>")
    ap.add_argument("--t-amb", type=float, default=25.0,
                    help="ambient degC the control plane senses")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the rest of the SPMD tier: a train "
            "step executed under the sharding plan across ranks (tensor "
            "and FSDP parallelism) and the step's hoist_gather, which the "
            "port does not have yet; one card trains with "
            "--model-parallel 1")
    if args.batch % args.n_accum:
        raise ValueError(f"--n-accum {args.n_accum} does not divide "
                         f"--batch {args.batch}")

    device = resolve_device(args.device)
    cfg, model, opt, train_step = build(args.arch, args.smoke, args.n_accum,
                                        device)
    print(f"[train] arch={cfg.name} params={model.n_params():,} "
          f"device={device}")
    params = model.weights()
    opt_state = opt.init(params)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    start_step = 0
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        restored, start_step = ckpt.restore({"params": params,
                                             "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        model.set_weights(params)
        print(f"[train] resumed from step {start_step}")

    it = make_iterator(cfg, dc, start_step=start_step, device=device)
    injector = FailureInjector(
        fail_at={args.inject_failure_at} if args.inject_failure_at >= 0
        else set())
    loop: Optional[ctl.ControlLoop] = None
    if args.energy_policy != "off":
        straggler, loop = _energy_loop(args, device)
    else:
        straggler = StragglerDetector()

    step = start_step
    metrics = None
    t_train0 = time.time()
    while step < args.steps:
        batch = next(it)

        def do_grads():
            injector.maybe_fail(step)
            return train_step.grads(params, batch)

        def on_fail(attempt, e):
            print(f"[ft] step {step} attempt {attempt} failed: {e}; "
                  f"retrying")

        t0 = time.time()
        # only the gradients are retried: the update writes the masters and
        # the moments in place, so a retry after a failure inside it would
        # step some leaves twice
        grads = retry_step(do_grads, on_failure=on_fail)
        params, opt_state, metrics = train_step.update(params, opt_state,
                                                       *grads, step)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        ev = straggler.record("worker0", step, dt)
        if ev:
            print(f"[ft] straggler: step {ev.step} {ev.ratio:.2f}x median")

        if step % args.log_every == 0 or step == args.steps - 1:
            msg = (f"[train] step {step}: loss={loss:.4f} "
                   f"acc={float(metrics['accuracy']):.3f} "
                   f"gnorm={float(metrics['grad_norm']):.2f} ({dt:.2f}s)")
            if loop is not None:
                # control tick: straggler events become policy decisions
                # (rail boost / rebalance), rails land on the actuator; the
                # energy line reads the controller's own plan
                rep = loop.step(now=float(step))
                for a in rep.actions:
                    if isinstance(a, (ctl.BoostRail, ctl.Rebalance)):
                        print(f"[ctl] {a}")
                rails = next(a for a in rep.actions
                             if isinstance(a, ctl.SetRails))
                p, ro = loop.controller.plan, rep.readout
                msg += (f" | energy[{args.energy_policy}]: "
                        f"save={p.saving*100:.1f}% Tmax={ro.t_max:.0f}C"
                        f" | ctl[{rails.source}]")
            print(msg)

        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      metadata={"arch": cfg.name})
        step += 1

    if ckpt:
        ckpt.wait()
    if metrics is None:
        print(f"[train] nothing to do: the run is at step {start_step} of "
              f"{args.steps}")
        return None
    final = float(metrics["loss"])
    print(f"[train] done: {args.steps - start_step} steps in "
          f"{time.time() - t_train0:.1f}s; final loss {final:.4f}")
    return final


if __name__ == "__main__":
    main()
