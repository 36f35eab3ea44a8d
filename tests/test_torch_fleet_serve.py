"""The port's pod-loss serving drill (``repro_torch.scenarios.
fleet_serve_replay``: one engine per pod over one shared host page pool,
drained at quarantine, its in-flight requests live-migrated to the
survivor) against the JAX package, on the CPU.

The drill of ``tests/test_fleet.py::TestPodLossServeDrill`` on
``llama3.2-1b.reduced()`` in float32, the reference's parameters carried
over by ``Model.load_reference``: ``pod_loss_day(ticks=16)`` at 2 pods,
the reference's test knots, 2 slots a pod, 2 engine steps a tick. The
port's ``outputs`` (rid for rid), ``caps``, ``finished``, ``rejected``,
``migrated``, ``quarantines``, ``pod_restores`` and tick counts equal the
reference's, ``energy_j`` within 1e-3 relative; zero requests are lost and
the outputs equal the no-failure day's. The host pool's provenance guard
(``HostPagePool.take(owner=)``) and ``Engine.drain`` behave as the
reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jsc
from repro.configs import registry as jregistry
from repro.core import runtime as JRT
from repro.core import tpu_fleet as JTF
from repro.models.model import Model as JModel
from repro.serve.cache import HostPagePool as JHostPagePool
from repro_torch import scenarios as sc
from repro_torch.configs import registry
from repro_torch.core import runtime as RT
from repro_torch.core import tpu_fleet as TF
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request
from repro_torch.serve.cache import HostPagePool
from test_torch_faults import one_thread  # noqa: F401

ARCH = "llama3.2-1b"
SW = (15.0, 40.0, 4)  # tests/test_fleet.py's drill settings
US = (0.25, 1.0, 3)
TRACE = [(t, 5, 20) for t in (1, 2, 3, 4, 4, 5)]
KW = dict(n_pods=2, sweep=SW, util_sweep=US, eos_id=-1, warmup=False,
          batch_slots=2, engine_steps=2)
EQUAL = ("outputs", "finished", "rejected", "tokens", "ticks",
         "engine_ticks", "migrated", "quarantines", "pod_restores",
         "preempts", "preempted_reqs", "max_wait", "mean_wait")


def _prof(TFmod):
    return TFmod.StepProfile.from_roofline(compute_s=0.8, memory_s=0.45,
                                           collective_s=0.2)


@pytest.fixture(scope="module")
def dense():
    """(JAX model, JAX params, the port's model on the CPU), float32."""
    jm = JModel(jregistry.get(ARCH).reduced().replace(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = registry.get(ARCH).reduced().replace(dtype="float32")
    return jm, jp, Model(cfg, device="cpu").load_reference(
        jax.device_get(jp))


@pytest.fixture(scope="module")
def rt():
    return RT.EnergyAwareRuntime(_prof(TF), policy="power_save",
                                 device="cpu")


def _clean(mod, day):
    """The no-failure day: the same ambient and load, no chaos."""
    return mod.Scenario(name=day.name, ticks=day.ticks, ambient=day.ambient,
                        load=day.load)


@pytest.fixture(scope="module")
def drills(dense, rt):
    """The drill through the reference and the port, and the port's
    no-failure day."""
    jm, jp, m = dense
    jrt = JRT.EnergyAwareRuntime(_prof(JTF), policy="power_save")
    want = jsc.fleet_serve_replay(
        jsc.pod_loss_day(ticks=16), jsc.trace_requests(TRACE, "podloss"),
        jm, jp, runtime=jrt, **KW)
    wl = sc.trace_requests(TRACE, "podloss")
    day = sc.pod_loss_day(ticks=16)
    got = sc.fleet_serve_replay(day, wl, m, runtime=rt, **KW)
    clean = sc.fleet_serve_replay(_clean(sc, day), wl, m, runtime=rt, **KW)
    paged = sc.fleet_serve_replay(day, wl, m, runtime=rt, paged=True, **KW)
    return got, want, clean, paged


@pytest.mark.parametrize("paged", [False, True])
def test_drill_equals_the_reference(drills, paged):
    """The reference's drill runs contiguous engines; the port's paged
    engines (the path the card's drill takes, through the paged kernel's
    plain version here) hold the same decisions and streams."""
    got, want = drills[3 if paged else 0], drills[1]
    for name in EQUAL:
        assert getattr(got, name) == getattr(want, name), name
    assert got.caps.tolist() == want.caps.tolist()
    assert got.energy_j == pytest.approx(want.energy_j, rel=1e-3)


def test_zero_lost_and_migrated(drills):
    got = drills[0]
    assert got.finished == len(TRACE) and got.rejected == 0
    assert got.migrated > 0  # requests were in flight at the loss
    assert got.quarantines == 1 and got.pod_restores == 1
    assert 0 < got.model_ticks <= got.engine_ticks


def test_outputs_equal_the_no_failure_day(drills):
    got, clean = drills[0], drills[2]
    assert clean.migrated == 0 and clean.quarantines == 0
    assert got.outputs == clean.outputs  # rid for rid
    assert all(len(o) == 20 for o in got.outputs)


def test_drill_is_deterministic(dense, rt, drills):
    got = drills[0]
    again = sc.fleet_serve_replay(
        sc.pod_loss_day(ticks=16), sc.trace_requests(TRACE, "podloss"),
        dense[2], runtime=rt, **KW)
    assert again.outputs == got.outputs
    assert again.caps.tolist() == got.caps.tolist()
    assert again.energy_j == got.energy_j


# ---------------------------------------------------------------------------
# the host pool's provenance ledger and the engine drain
# ---------------------------------------------------------------------------


class _Alloc:
    def __init__(self, max_len=64):
        self.max_len = max_len


def _pool_trace(cls, rows):
    """tests/test_fleet.py::TestHostPoolLedger on one pool class;
    ``rows()`` makes a parked request's rows of that package."""
    pool = cls()
    home, away, small = _Alloc(), _Alloc(), _Alloc(max_len=4)
    out = []

    def take(rid, owner):
        try:
            _, pos = pool.take(rid, owner=owner)
            out.append(("ok", rid, pos, pool.migrations, pool.pages_held))
        except RuntimeError as e:
            out.append(("refused", rid, "foreign" in str(e),
                        "max_len" in str(e)))

    pool.put("r1", rows(), pos=8, pages=1, owner=home, page_ids=[4],
             freed=False)
    take("r1", away)   # the origin still owns the pages: refused
    take("r1", home)   # home may always resume
    pool.put("r2", rows(), pos=8, pages=2, owner=home, freed=True)
    take("r2", away)   # freed: a migration
    pool.put("r3", rows(), pos=8, pages=1, owner=_Alloc())
    take("r3", small)  # does not fit the target's span
    out.append((len(pool), pool.puts, pool.peak, pool.pages_evicted,
                pool.peak_pages, pool.put_pages("r3")))
    return out


def test_foreign_resume_guard_equals_the_reference():
    got = _pool_trace(HostPagePool, lambda: torch.zeros(3))
    assert got == _pool_trace(JHostPagePool, lambda: np.zeros(3))
    assert got[0] == ("refused", "r1", True, False)
    assert got[2][:4] == ("ok", "r2", 8, 1)
    assert got[3] == ("refused", "r3", False, True)


def test_drain_returns_everything_resumable(dense):
    """tests/test_fleet.py::TestEngineDrain: a drained engine hands back
    its active and queued requests; a second engine over the same pool
    finishes them with the streams the undisturbed engine gives."""
    m = dense[2]
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(4)]

    def engine(pool=None):
        return Engine(m, batch_slots=2, max_len=64, eos_id=-1, paged=True,
                      warmup=False, pool=pool)

    ref = engine()
    for i, p in enumerate(prompts):
        ref.submit(Request(i, p, max_new=12))
    while ref.step():
        pass
    want = {r.rid: list(r.out) for r in ref.finished}

    pool = HostPagePool()
    eng = engine(pool)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=12))
    for _ in range(3):
        eng.step()  # two active mid-decode, two queued
    out = eng.drain()
    assert sorted(r.rid for r in out) == [0, 1, 2, 3]
    assert not eng.queue and all(r is None for r in eng.slot_req)
    assert eng.mgr.free_pages == eng.mgr.total_pages
    eng2 = engine(pool)
    for r in out:
        eng2.submit(r)
    while eng2.step():
        pass
    assert pool.migrations == 2  # the two active slots moved allocators
    assert {r.rid: list(r.out) for r in eng2.finished} == want
