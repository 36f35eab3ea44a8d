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
field, whose 256 cells solve as one direct product).

``--model-parallel N`` trains across the ranks of a process group, as the
reference's ``build`` does on its host mesh: ``make_host_mesh(model=N)``
over the world, the plan, ``Model(cfg, plan=...)`` and the sharded step
(``train/step.py``: tensor parallelism over N ranks, FSDP over the rest),
each rank drawing the same weights from the seed and keeping its shards.
It runs every family: dense, moe (mixtral-8x7b, deepseek-v2-236b: the
experts over the model axis, or inside each expert where N does not
divide their count), ssm (mamba2-780m) and hybrid (zamba2-1.2b), the
Mamba2 scan on each rank's heads, vlm (llama-3.2-vision-11b) and audio
(whisper-small), their stub inputs split over the data ranks as the
tokens are.
Under ``torchrun`` (the environment's ``WORLD_SIZE``) the CLI joins the
group itself: gloo when the ranks share a card (or run on the CPU), NCCL
when each has its own. One card, four ranks, tensor parallelism 2:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --model-parallel 2

Under torchrun even ``--model-parallel 1`` trains across the world (FSDP
alone); without a process group ``--model-parallel`` above 1 raises: the
CLI never runs one rank in place of many. Across ranks it prints from
rank 0, and ``--checkpoint-dir`` keeps the one-process format: every rank
gathers the state and rank 0 writes it (``CheckpointManager(...,
across_ranks=True)``); ``--resume`` places the saved arrays at the plan's
placements on every rank, so a checkpoint moves between world sizes.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

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
from repro_torch.launch.mesh import PodTopology, make_host_mesh
from repro_torch.models import params as pm
from repro_torch.models.model import Model
from repro_torch.sharding import spmd
from repro_torch.sharding.plan import make_plan
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step


def build(arch: str, smoke: bool, n_accum: int, device=None, seed: int = 0,
          mesh=None):
    """-> (cfg, model, optimizer, the train step, params, optimizer
    state), the weights random from ``seed``. With ``mesh`` (a
    ``DeviceMesh`` over the process group) the step is the sharded one and
    params and state are ``DTensor`` s at the plan's FSDP placements: each
    rank draws the whole tree from the seed on ``device`` and keeps its
    shards (the model holds no weights of its own), and the step hoists
    the FSDP gather out of the microbatch loop (``hoist_gather``: one
    gather a step where it applies; eager PyTorch does not hoist it
    itself)."""
    cfg = registry.get(arch)
    if smoke:
        cfg = cfg.reduced()
    opt = make_optimizer(cfg, total_steps=10_000)
    if mesh is None:
        model = Model(cfg, device=device).init(seed)
        params = model.weights()
        return (cfg, model, opt, make_train_step(model, opt, n_accum=n_accum),
                params, opt.init(params))
    model = Model(cfg, plan=make_plan(cfg, mesh), device=device)
    params, opt_state = init_sharded(model, opt, seed)
    return (cfg, model, opt, make_train_step(model, opt, n_accum=n_accum,
                                             hoist_gather=True),
            params, opt_state)


def init_sharded(model: Model, opt, seed: int):
    """Weights drawn from ``seed`` (``Model.init``'s draws) and zero
    optimizer state, each leaf at the plan's FSDP sharding: every rank
    draws the whole weight tree, keeps its shards and allocates only its
    shards of the state."""
    plan, meta = model.plan, model.param_meta()
    gen = torch.Generator(device=model.device)
    gen.manual_seed(int(seed))
    full = pm.materialize(meta, gen, model.cfg.param_dtype, model.device)
    it = iter(pm.tree_leaves(plan.param_shardings(meta)))
    params = pm.tree_map(lambda t: spmd.place(t, next(it)), full)
    del full
    state_meta = opt.state_meta(meta)
    it = iter(pm.tree_leaves(plan.param_shardings(state_meta)))
    return params, pm.tree_map(lambda m: spmd.zeros(
        m.shape, pm.torch_dtype(m.dtype), next(it), model.device),
        state_meta)


def join_world(model_parallel: int, device):
    """The ``DeviceMesh`` of ``--model-parallel`` over the process group,
    joined from ``torchrun`` 's environment where none is initialised yet
    (gloo when the ranks share a card or run on the CPU, NCCL when each
    rank has its own); raises without a process group."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--model-parallel {model_parallel} trains across the ranks "
                f"of a process group, and there is none: launch with "
                f"torchrun (torchrun --nproc-per-node 4 -m "
                f"repro_torch.launch.train --model-parallel 2) or initialise "
                f"torch.distributed first")
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", 0))
        own_card = (device.type == "cuda"
                    and torch.cuda.device_count() >= int(
                        os.environ.get("LOCAL_WORLD_SIZE", world)))
        if device.type == "cuda":
            torch.cuda.set_device(local if own_card else 0)
        dist.init_process_group("nccl" if own_card else "gloo")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the world of {n} ranks")
    return make_host_mesh(model=model_parallel, device=device)


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
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="a registry config, e.g. llama3.2-1b, "
                    "mixtral-8x7b, deepseek-v2-236b, mamba2-780m, "
                    "zamba2-1.2b, llama-3.2-vision-11b, whisper-small")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel ranks of a process group (torchrun"
                    "), FSDP over the rest: the dense, moe, ssm and hybrid "
                    "families (attention and MLA on local heads, MoE "
                    "experts over the ranks or inside each expert, Mamba2 "
                    "on local heads) and the vlm and audio families")
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
    if args.batch % args.n_accum:
        raise ValueError(f"--n-accum {args.n_accum} does not divide "
                         f"--batch {args.batch}")

    device = resolve_device(args.device)
    mesh = None
    if (args.model_parallel > 1 or dist.is_initialized()
            or "WORLD_SIZE" in os.environ):
        mesh = join_world(args.model_parallel, device)
    lead = mesh is None or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    cfg, model, opt, train_step, params, opt_state = build(
        args.arch, args.smoke, args.n_accum, device, mesh=mesh)
    log(f"[train] arch={cfg.name} params={model.n_params():,} "
        f"device={device}"
        + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
           if mesh is not None else ""))

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    start_step = 0
    ckpt = CheckpointManager(args.checkpoint_dir,
                             across_ranks=mesh is not None) \
        if args.checkpoint_dir else None
    latest = ckpt.latest_step() if ckpt and args.resume else None
    if latest is not None:
        shardings = None
        if mesh is not None:  # the saved arrays at the plan's placements
            meta = model.param_meta()
            shardings = {"params": model.plan.param_shardings(meta),
                         "opt": model.plan.param_shardings(
                             opt.state_meta(meta))}
        restored, start_step = ckpt.restore(
            {"params": params, "opt": opt_state}, latest, shardings)
        params, opt_state = restored["params"], restored["opt"]
        if mesh is None:
            model.set_weights(params)
        log(f"[train] resumed from step {start_step}")

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
            log(f"[ft] step {step} attempt {attempt} failed: {e}; "
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
            log(f"[ft] straggler: step {ev.step} {ev.ratio:.2f}x median")

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
                        log(f"[ctl] {a}")
                rails = next(a for a in rep.actions
                             if isinstance(a, ctl.SetRails))
                p, ro = loop.controller.plan, rep.readout
                msg += (f" | energy[{args.energy_policy}]: "
                        f"save={p.saving*100:.1f}% Tmax={ro.t_max:.0f}C"
                        f" | ctl[{rails.source}]")
            log(msg)

        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      metadata={"arch": cfg.name})
        step += 1

    if ckpt:
        ckpt.wait()
    if metrics is None:
        log(f"[train] nothing to do: the run is at step {start_step} of "
              f"{args.steps}")
        return None
    final = float(metrics["loss"])
    log(f"[train] done: {args.steps - start_step} steps in "
          f"{time.time() - t_train0:.1f}s; final loss {final:.4f}")
    return final


if __name__ == "__main__":
    main()
