"""Algorithm 1 over all ten VTR benchmarks at the paper's Fig 6 points,
(40 degC, theta_JA 12) and (65 degC, theta_JA 2): the PyTorch port against
the JAX package on the CPU, 20 cases. This file holds the first five
benchmarks, ``tests/test_torch_vtr_fig6_b.py`` the other five, so that
two test processes share the ~85 s.

Each case runs ``voltage_scaling.run`` at activity 1.0 (Fig 6's high end)
in both packages and holds the port to the reference: the same rails at
every iteration, the power of each iteration and of the result within 1e-3
relative (the golden tolerance of ``tests/test_policy_api.py``), the
saving within 1e-4.
"""
import pytest

from repro.core import thermal as JT
from repro.core import voltage_scaling as JVS
from repro.core import vtr_benchmarks as jvb
from repro_torch.core import thermal as TT
from repro_torch.core import voltage_scaling as TVS
from repro_torch.core import vtr_benchmarks as tvb

# Fig 6's two points: (ambient degC, theta_JA)
POINTS = ((40.0, 12.0), (65.0, 2.0))
NAMES = [b.name for b in tvb.BENCHES]
FIRST = NAMES[:5]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: torch on one thread beside the other test processes (as
    in ``tests/test_torch_faults.py``)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_lists_the_reference_benchmarks():
    assert NAMES == [b.name for b in jvb.BENCHES]


def hold_algorithm1(name, t_amb, theta):
    """One case: the port's run against the reference's (module
    docstring)."""
    ref = JVS.run(jvb.load(name), t_amb, 1.0,
                  JT.ThermalConfig(theta_ja=theta))
    got = TVS.run(tvb.load(name), t_amb, 1.0,
                  TT.ThermalConfig(theta_ja=theta), device="cpu")
    assert [(t.v_core, t.v_bram) for t in got.trace] == \
        [(t.v_core, t.v_bram) for t in ref.trace]
    for g, r in zip(got.trace, ref.trace):
        assert g.power_mw == pytest.approx(r.power_mw, rel=1e-3)
    assert (got.v_core, got.v_bram) == (ref.v_core, ref.v_bram)
    assert got.power_mw == pytest.approx(ref.power_mw, rel=1e-3)
    assert got.converged == ref.converged
    assert got.saving == pytest.approx(ref.saving, abs=1e-4)


POINT_IDS = ["40C-theta12", "65C-theta2"]


@pytest.mark.parametrize("t_amb,theta", POINTS, ids=POINT_IDS)
@pytest.mark.parametrize("name", FIRST)
def test_algorithm1_equals_reference(name, t_amb, theta):
    hold_algorithm1(name, t_amb, theta)
