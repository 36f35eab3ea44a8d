"""The port's timing-fault model, SDC injector and TPU-fleet library against
the JAX package.

The continuous queries (delay factor, overshoot, SDC rates, bit profiles,
chip power) agree within 1e-6 relative, the float32 tolerance of one
``pow``/``exp`` rounded by another library. The injector's counts are equal: both
draw from numpy's ``default_rng`` in the same order.
"""
import numpy as np
import pytest
import torch

from repro.core import tpu_fleet as JTF
from repro.tolerance import FaultInjector as JFaultInjector
from repro.tolerance import SdcCounts as JSdcCounts
from repro.tolerance import TimingFaultModel as JTimingFaultModel
from repro_torch.core import tpu_fleet as TTF
from repro_torch.tolerance import FaultInjector, SdcCounts, TimingFaultModel

RAILS = [0.60, 0.66, 0.70, 0.705, 0.715, 0.7265, 0.73, 0.75, 0.80]
SRAM = [0.80, 0.85]
TEMPS = [25.0, 45.0, 65.0, 85.0, 95.0]


def _grid():
    vc, vs, T = np.meshgrid(RAILS, SRAM, TEMPS, indexing="ij")
    return (vc.ravel().astype(np.float32), vs.ravel().astype(np.float32),
            T.ravel().astype(np.float32))


def test_f_max_rel_and_delay_factor():
    vc, vs, T = _grid()
    lib_j, lib_t = JTF.TpuLibrary(), TTF.TpuLibrary()
    want = np.asarray(JTF.f_max_rel(lib_j, vc, vs, T))
    got = TTF.f_max_rel(lib_t, torch.from_numpy(vc), torch.from_numpy(vs),
                        torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for cls in range(5):
        np.testing.assert_allclose(
            lib_t.delay_factor(cls, vc, T).numpy(),
            np.asarray(lib_j.delay_factor(np.int32(cls), vc, T)), rtol=1e-6)


def test_fault_model_queries():
    vc, vs, T = _grid()
    fj, ft = JTimingFaultModel(), TimingFaultModel()
    for q in ("overshoot", "sdc_rate", "escaped_rate"):
        np.testing.assert_allclose(getattr(ft, q)(vc, vs, T),
                                   getattr(fj, q)(vc, vs, T), rtol=1e-6)
    assert np.array_equal(ft.overshoot(vc, vs, T) > 0,
                          fj.overshoot(vc, vs, T) > 0)
    for v, s, t in zip(vc, vs, T):
        np.testing.assert_allclose(ft.bit_probs(v, s, t),
                                   fj.bit_probs(v, s, t), rtol=1e-6)


@pytest.mark.parametrize("T", [45.0, 65.0, 85.0])
def test_guard_band_rails_inject_nothing(T):
    ft = TimingFaultModel()
    assert ft.overshoot(TTF.V_CORE_NOM, TTF.V_SRAM_NOM, T) == 0.0
    assert not ft.bit_probs(TTF.V_CORE_NOM, TTF.V_SRAM_NOM, T).any()
    assert ft.bit_probs(0.70, TTF.V_SRAM_NOM, T).sum() > 0


def test_injector_counts_equal_reference():
    fj = JFaultInjector(JTimingFaultModel(), seed=7)
    ft = FaultInjector(TimingFaultModel(), seed=7)
    rng = np.random.default_rng(0)
    for tick in range(20):
        vc = rng.uniform(0.69, 0.76, 16)
        T = rng.uniform(40.0, 80.0, 16)
        util = rng.uniform(0.2, 1.0, 16) if tick % 2 else None
        a = fj.tick(float(tick), vc, TTF.V_SRAM_NOM, T, util=util)
        b = ft.tick(float(tick), vc, TTF.V_SRAM_NOM, T, util=util)
        assert vars(a) == vars(b)
    assert vars(ft.totals) == vars(fj.totals)
    assert ft.totals.injected > 0
    assert ft.totals.escape_rate == fj.totals.escape_rate
    ft.reset(3)
    fj.reset(3)
    assert vars(ft.tick(0.0, 0.70, 0.85, 65.0)) == \
        vars(fj.tick(0.0, 0.70, 0.85, 65.0))


def test_sdc_counts_add():
    a, b = SdcCounts(1, 2, 3, 4, 5), JSdcCounts(1, 2, 3, 4, 5)
    a.add(SdcCounts(1, 1, 1, 1, 10))
    b.add(JSdcCounts(1, 1, 1, 1, 10))
    assert vars(a) == vars(b) and a.escape_rate == b.escape_rate


def test_tpu_fleet_power_and_step_time():
    vc, vs, T = _grid()
    lib_j, lib_t = JTF.TpuLibrary(), TTF.TpuLibrary()
    prof_j = JTF.StepProfile.from_roofline(0.8, 0.45, 0.2)
    prof_t = TTF.StepProfile.from_roofline(0.8, 0.45, 0.2)
    assert vars(prof_t) == vars(prof_j)
    f = np.linspace(0.6, 1.1, vc.size).astype(np.float32)
    np.testing.assert_allclose(
        TTF.chip_power(lib_t, prof_t, vc, vs, f, T).numpy(),
        np.asarray(JTF.chip_power(lib_j, prof_j, vc, vs, f, T)), rtol=1e-6)
    np.testing.assert_allclose(
        TTF.step_time(prof_t, f).numpy(),
        np.asarray(JTF.step_time(prof_j, f)), rtol=1e-6)
    for cls in range(5):
        np.testing.assert_allclose(
            lib_t.leakage(cls, vc, T).numpy(),
            np.asarray(lib_j.leakage(np.int32(cls), vc, T)), rtol=1e-6)
    pj, pt = JTF.pod_thermal_config(), TTF.pod_thermal_config()
    for k in ("theta_ja", "spreading", "tol", "max_iters"):
        assert getattr(pt, k) == getattr(pj, k)
