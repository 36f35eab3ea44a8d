"""The port's thermal-aware admission (``repro_torch.control.admission``)
and the §8 serving day (``repro_torch.scenarios.serve_replay``) against
the JAX package, on the CPU.

The cases of ``tests/test_admission.py``, fed to both packages: the
pricing decisions (caps, the counters) on the same snapshots; the
workloads (the same arrivals from the same seeds); and the acceptance
replays on ``llama3.2-1b.reduced()`` in float32, the reference's
parameters carried over by ``Model.load_reference`` — throughput-only,
thermal-aware, and thermal-aware with preemption under a hotspot. Each
replay's ``outputs``, ``caps``, ``deferred``, ``forced``, ``finished``,
``preempts`` and ``preempted_reqs`` equal the reference's, and
``energy_j`` agrees within 1e-3 relative. (The reference's sha256
``fingerprint`` hashes floats; the port is not held to it.)
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import control as jctl
from repro import scenarios as jsc
from repro.configs import registry as jregistry
from repro.core import runtime as JRT
from repro.core import tpu_fleet as JTF
from repro.models.model import Model as JModel
from repro_torch import control as ctl
from repro_torch import scenarios as sc
from repro_torch.configs import registry
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF
from repro_torch.models.model import Model

ARCH = "llama3.2-1b"
SLO = 60.0  # engine ticks, submit -> finish (tests/test_admission.py)


def _prof(TFmod):
    return TFmod.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                           collective_s=0.2)


@pytest.fixture(scope="module")
def both():
    """{"jax": (runtime, field), "torch": (runtime, field)}, the field on
    tests/test_admission.py's knots."""
    jrt = JRT.EnergyAwareRuntime(_prof(JTF), policy="power_save")
    rt = RT.EnergyAwareRuntime(_prof(TF), policy="power_save", device="cpu")
    knots = (ctl.sweep_points(10.0, 45.0, 4), ctl.sweep_points(0.25, 1.0, 4))
    return {"jax": (jrt, jrt.build_field(*knots)),
            "torch": (rt, rt.build_field(*knots))}


MODS = {"jax": jctl, "torch": ctl}


def _adm(side, both, **kw):
    rt, field = both[side]
    mod = MODS[side]
    kw.setdefault("defer_premium", 1.05)
    kw.setdefault("max_wait", 64.0)
    return mod.AdmissionController(
        mod.LutController(rt.planner, field=field, guard_band_c=3.0), **kw)


def _cap(actions):
    thr = [a for a in actions if type(a).__name__ == "Throttle"]
    assert len(thr) == 1  # exactly one joint Throttle per decision
    return thr[0].admit_cap


def _snap(mod, t_amb, queued=3, active=0, slots=4, wait=0.0, t_chip=None):
    return mod.Snapshot(t_amb=t_amb, queued=queued, active=active,
                        slots=slots, oldest_wait=wait, t_chip=t_chip)


HOT = np.full(256, TF.T_MAX_CHIP - 1.0)
COOL = np.full(256, 60.0)
# tests/test_admission.py::TestAdmissionPricing and a preempting case, as
# (controller kwargs, [snapshot kwargs per decision], the expected caps)
PRICING = {
    "cold_admits_hot_defers": ({}, [dict(t_amb=10.0), dict(t_amb=44.0)],
                               [3, 0]),
    "slo_forcing": ({"max_wait": 8.0}, [dict(t_amb=44.0, wait=7.9),
                                        dict(t_amb=44.0, wait=8.0)], [0, 3]),
    "min_active_floor": ({"min_active": 1},
                         [dict(t_amb=44.0, active=0),
                          dict(t_amb=44.0, active=1)], [1, 0]),
    "free_slots_bound": ({}, [dict(t_amb=10.0, queued=9, active=3),
                              dict(t_amb=10.0, queued=9, active=4)], [1, 0]),
    "thermal_emergency_floors": (
        {}, [dict(t_amb=10.0, t_chip=HOT), dict(t_amb=10.0, t_chip=HOT),
             dict(t_amb=10.0, t_chip=COOL)], [1, 1, 3]),
    "preempt_escalation": (
        {"preempt": True}, [dict(t_amb=10.0, active=3, t_chip=HOT),
                            dict(t_amb=10.0, active=3, t_chip=HOT)],
        [1, 1]),
}


@pytest.mark.parametrize("case", list(PRICING))
def test_pricing_decisions_equal_the_reference(both, case):
    kw, snaps, caps = PRICING[case]
    out = {}
    for side in ("torch", "jax"):
        adm = _adm(side, both, **kw)
        acts = [adm.decide(_snap(MODS[side], **s)) for s in snaps]
        rails = [np.asarray(a.v_core, np.float32).tobytes()
                 for acts_i in acts for a in acts_i
                 if type(a).__name__ == "SetRails"]
        kinds = [[type(a).__name__ for a in acts_i] for acts_i in acts]
        out[side] = ([_cap(a) for a in acts], kinds, rails,
                     dataclasses.astuple(adm.stats))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == caps
    if case == "preempt_escalation":
        assert out["torch"][3][-1] == 2  # a Preempt on both hot ticks


def test_rails_ride_with_the_throttle(both):
    """SetRails and Throttle land as ONE decision, with rails at the
    planned (post-admission) utilization."""
    adm = _adm("torch", both)
    acts = adm.decide(_snap(ctl, 10.0))
    rails = [a for a in acts if isinstance(a, ctl.SetRails)]
    assert len(rails) == 1 and _cap(acts) == 3
    vc_idle, _ = both["torch"][1].lookup(10.0, 0.25)
    assert (float(np.median(np.asarray(rails[0].v_core)))
            > float(np.median(vc_idle)))


def test_passthrough_without_pricing_signal(both):
    adm = _adm("torch", both)
    acts = adm.decide(_snap(ctl, 25.0, slots=0))
    assert not any(isinstance(a, ctl.Throttle) for a in acts)
    assert adm.stats.passthrough == 1


@pytest.mark.parametrize("make", [
    lambda m: m.poisson_requests(ticks=8, rate=1.5, seed=0),
    lambda m: m.poisson_requests(ticks=8, rate=1.5, seed=1),
    lambda m: m.poisson_burst(burst_at=2, burst_n=5, tail_ticks=3, seed=7),
    lambda m: m.poisson_burst(burst_at=1, burst_n=12, prompt_len=384,
                              max_new=32, tail_ticks=4, tail_rate=0.5),
    lambda m: m.trace_requests([(0, 4, 2), (3, 8, 5)]),
], ids=["poisson0", "poisson1", "burst", "card_burst", "trace"])
def test_workloads_equal_the_reference(make):
    got, want = make(sc), make(jsc)
    assert got.name == want.name
    assert [dataclasses.astuple(a) for a in got.arrivals] == [
        dataclasses.astuple(a) for a in want.arrivals]
    assert got.fingerprint == want.fingerprint
    assert ({t: [a.rid for a in v] for t, v in got.by_tick().items()}
            == {t: [a.rid for a in v] for t, v in want.by_tick().items()})


def test_serve_day_and_prompts_equal_the_reference():
    a, b = sc.serve_day(), jsc.serve_day()
    assert (a.name, a.ticks) == (b.name, b.ticks)
    assert [a.ambient_at(t) for t in range(20)] == [
        b.ambient_at(t) for t in range(20)]
    np.testing.assert_array_equal(sc.serve_prompt(5, 384, 1000),
                                  jsc.serve_prompt(5, 384, 1000))


# ---------------------------------------------------------------------------
# the acceptance replays (tests/test_admission.py::TestServeReplayAcceptance)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    """(JAX model, JAX params, the port's model on the CPU), float32."""
    jcfg = jregistry.get(ARCH).reduced().replace(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(ARCH).reduced().replace(dtype="float32")
    return jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


def _day(mod, hotspots=False):
    day = mod.serve_day(ticks=10, hot=42.0, cool=12.0, cool_at=5)
    if hotspots:  # a runaway after the cool-down, with the slots busy
        day = dataclasses.replace(
            day, hotspots=tuple(mod.Hotspot(t, 0, TF.T_MAX_CHIP - 1.0)
                                for t in (6, 7)))
    return day


def _replay(side, both, dense, kind):
    jm, jp, m = dense
    mod, smod = MODS[side], {"jax": jsc, "torch": sc}[side]
    rt, field = both[side]
    lut = mod.LutController(rt.planner, field=field, guard_band_c=3.0)
    controller = lut if kind == "throughput" else mod.AdmissionController(
        lut, defer_premium=1.05, max_wait=240.0, preempt=kind == "preempt")
    wl = smod.poisson_burst(burst_at=1, burst_n=6, tail_ticks=2, seed=0)
    day = _day(smod, hotspots=kind == "preempt")
    if side == "jax":
        return smod.serve_replay(day, wl, jm, jp, controller=controller,
                                 runtime=rt)
    return smod.serve_replay(day, wl, m, controller=controller, runtime=rt)


KINDS = ("throughput", "thermal", "preempt")


@pytest.fixture(scope="module")
def runs(both, dense):
    return {(side, kind): _replay(side, both, dense, kind)
            for side in ("torch", "jax") for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_replay_equals_the_reference(runs, kind):
    got, want = runs["torch", kind], runs["jax", kind]
    assert got.outputs == want.outputs
    assert got.caps.tolist() == want.caps.tolist()
    for name in ("ticks", "engine_ticks", "finished", "rejected", "tokens",
                 "deferred", "forced", "preempts", "preempted_reqs"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.energy_j == pytest.approx(want.energy_j, rel=1e-3)
    assert got.max_wait == want.max_wait and got.mean_wait == want.mean_wait
    assert 0 < got.model_ticks <= got.engine_ticks


def test_thermal_beats_throughput_at_equal_slo(runs):
    thru, therm = runs["torch", "throughput"], runs["torch", "thermal"]
    assert thru.outputs == therm.outputs
    n = len(sc.poisson_burst(burst_at=1, burst_n=6, tail_ticks=2,
                             seed=0).arrivals)
    assert thru.finished == therm.finished == n
    assert thru.rejected == therm.rejected == 0
    assert thru.max_wait <= SLO and therm.max_wait <= SLO
    assert therm.deferred > 0
    assert therm.tokens_per_joule > thru.tokens_per_joule


def test_thermal_emergency_preempts_and_resumes_identically(runs):
    thru, pre = runs["torch", "throughput"], runs["torch", "preempt"]
    assert pre.preempts > 0 and pre.preempted_reqs > 0
    assert pre.outputs == thru.outputs
    assert pre.finished == thru.finished


def test_replay_is_deterministic(both, dense, runs):
    again = _replay("torch", both, dense, "thermal")
    first = runs["torch", "thermal"]
    assert again.outputs == first.outputs
    assert again.caps.tolist() == first.caps.tolist()
    assert again.energy_j == first.energy_j
