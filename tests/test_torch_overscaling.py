"""§III-D over-scaling of the port against the JAX package.

Decisions (rails per budget, iteration counts) are equal; powers agree to
1e-3 relative and the violating fraction to 1/256 (one path of 256), the
tolerances of the reference's golden pins. ``error_profile`` is held to the
reference's within 1e-12 on the same temperature field. The LeNet and HD
netlists (56x56, 69x69) run in ``chip_smoke.py``; here the 21x21 raygentop
keeps the suite short.
"""
import numpy as np
import pytest
import torch

from repro import policy as jpol
from repro.core import overscaling as JOS
from repro.core import thermal as JT
from repro.core import vtr_benchmarks as jvb
from repro_torch import policy as tpol
from repro_torch.core import overscaling as TOS
from repro_torch.core import thermal as TT
from repro_torch.core import vtr_benchmarks as tvb

GOLDEN_OS = {"v_core": 0.66, "v_bram": 0.70, "power_mw": 39.173454,
             "saving": 0.454091,
             "frac_violating": 0.542969}  # OS.run(raygentop, g=1.2, 40C)
GAMMAS = [1.0, 1.2, 1.35]


def _same(got, want):
    assert (got.v_core, got.v_bram) == pytest.approx(
        (want.v_core, want.v_bram), abs=1e-6)
    assert got.power_mw == pytest.approx(want.power_mw, rel=1e-3)
    assert got.baseline_mw == pytest.approx(want.baseline_mw, rel=1e-3)
    assert got.saving == pytest.approx(want.saving, abs=1e-3)
    assert got.frac_violating == pytest.approx(want.frac_violating,
                                               abs=1 / 256)
    assert got.mean_overshoot == pytest.approx(want.mean_overshoot,
                                               rel=1e-3, abs=1e-6)
    assert got.t_junct == pytest.approx(want.t_junct, abs=2e-2)


def test_golden_os():
    r = TOS.run(tvb.load("raygentop"), 1.2, t_amb=40.0,
                tc=TT.ThermalConfig(theta_ja=12.0), device="cpu")
    assert r.gamma == 1.2
    assert r.v_core == pytest.approx(GOLDEN_OS["v_core"], abs=1e-3)
    assert r.v_bram == pytest.approx(GOLDEN_OS["v_bram"], abs=1e-3)
    assert r.power_mw == pytest.approx(GOLDEN_OS["power_mw"], rel=1e-3)
    assert r.saving == pytest.approx(GOLDEN_OS["saving"], abs=1e-3)
    assert r.frac_violating == pytest.approx(GOLDEN_OS["frac_violating"],
                                             abs=1e-3)


@pytest.fixture(scope="module")
def raygentop_sweeps():
    want = JOS.sweep(jvb.load("raygentop"), GAMMAS, t_amb=40.0,
                     tc=JT.ThermalConfig(theta_ja=12.0))
    got = TOS.sweep(tvb.load("raygentop"), GAMMAS, t_amb=40.0,
                    tc=TT.ThermalConfig(theta_ja=12.0), device="cpu")
    return got, want


def test_sweep_matches_reference(raygentop_sweeps):
    got, want = raygentop_sweeps
    assert [r.gamma for r in got] == GAMMAS
    for g, w in zip(got, want):
        _same(g, w)
        np.testing.assert_allclose(g.bit_probs, w.bit_probs, rtol=0,
                                   atol=1e-12)
    # a looser budget never costs power, and gamma = 1.0 violates nothing
    assert got[0].frac_violating == 0.0 and not got[0].bit_probs.any()
    assert got[0].power_mw >= got[1].power_mw >= got[2].power_mw


def test_sweep_equals_single_runs(raygentop_sweeps):
    got, _ = raygentop_sweeps
    for r in got:
        one = TOS.run(tvb.load("raygentop"), r.gamma, t_amb=40.0,
                      tc=TT.ThermalConfig(theta_ja=12.0), device="cpu")
        assert (one.v_core, one.v_bram) == (r.v_core, r.v_bram)
        assert one.power_mw == pytest.approx(r.power_mw, rel=1e-5)
        np.testing.assert_array_equal(one.bit_probs, r.bit_probs)


@pytest.mark.parametrize("vc,vb", [(0.66, 0.70), (0.63, 0.55), (0.72, 0.71)])
def test_error_profile_matches_reference(vc, vb):
    nl_t, nl_j = tvb.load("raygentop"), jvb.load("raygentop")
    tc = TT.ThermalConfig(theta_ja=12.0)
    sub_t = tpol.fpga_substrate(nl_t, tc=tc, device="cpu")
    sub_j = jpol.fpga_substrate(nl_j, tc=JT.ThermalConfig(theta_ja=12.0))
    T = np.random.default_rng(0).uniform(40.0, 60.0, nl_t.n_tiles).astype(
        np.float32)
    got = TOS.error_profile(sub_t.lib, sub_t.nlt, nl_t, torch.from_numpy(T),
                            vc, vb, sub_t.d_worst, 1.0)
    want = JOS.error_profile(sub_j.lib, sub_j.nlj, nl_j, T, vc, vb,
                             sub_j.d_worst, 1.0)
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    assert got[1] == pytest.approx(want[1], rel=1e-5, abs=1e-12)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)


def test_run_takes_a_policy_and_needs_a_card_without_a_device(monkeypatch):
    r = TOS.run(tvb.load("raygentop"), 1.2, t_amb=40.0,
                tc=TT.ThermalConfig(theta_ja=12.0),
                policy=tpol.Overscale(gamma=1.5), device="cpu")
    assert (r.v_core, r.v_bram) == pytest.approx((0.66, 0.70), abs=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOS.run(tvb.load("raygentop"), 1.2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOS.sweep(tvb.load("raygentop"), [1.0])
