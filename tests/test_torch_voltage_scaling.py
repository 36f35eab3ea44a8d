"""Algorithm 1 and 2 end to end: the PyTorch port against the JAX package.

Decisions (iteration counts, per-iteration rails, LUT entries) must be
equal; powers agree to 1e-3 relative and junction temperatures to
2e-2 degC, the tolerances the reference's own golden pins and tier-parity
tests use. Also: the port never imports JAX or the reference package, and
an entry point called without a device refuses to run on a machine with no
CUDA card.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import energy_opt as JEO
from repro.core import thermal as JT
from repro.core import voltage_scaling as JVS
from repro.core import vtr_benchmarks as jvb
from repro_torch import policy as tpol
from repro_torch.core import energy_opt as TEO
from repro_torch.core import thermal as TT
from repro_torch.core import voltage_scaling as TVS
from repro_torch.core import vtr_benchmarks as tvb

ROOT = Path(__file__).resolve().parents[1]
# the reference's pins (tests/test_policy_api.py), captured on the seed
GOLDEN_VS = {"v_core": 0.74, "v_bram": 0.79, "power_mw": 8.458870,
             "iters": 2}  # VS.run(mkPktMerge, 60C, act 1.0, theta 12)
GOLDEN_EO = {"v_core": 0.55, "v_bram": 0.55, "d_opt_ns": 17.019848,
             "energy": 27.992240, "saving": 0.640888,
             "freq_ratio": 0.367218}  # EO.run(mkPktMerge, 65C, theta 2)


@pytest.fixture(scope="module")
def table2():
    """The paper's Table II case: mkDelayWorker32B, 60 C, theta_JA 12."""
    ref = JVS.run(jvb.load("mkDelayWorker32B"), 60.0, 1.0,
                  JT.ThermalConfig(theta_ja=12.0))
    got = TVS.run(tvb.load("mkDelayWorker32B"), 60.0, 1.0,
                  TT.ThermalConfig(theta_ja=12.0), device="cpu")
    return ref, got


def test_table2_trace_matches_reference(table2):
    ref, got = table2
    assert len(got.trace) == len(ref.trace) == 4
    for g, r in zip(got.trace, ref.trace):
        assert (g.v_core, g.v_bram) == (r.v_core, r.v_bram)
        assert g.power_mw == pytest.approx(r.power_mw, rel=1e-3)
        assert g.t_junct == pytest.approx(r.t_junct, abs=2e-2)
    assert (got.v_core, got.v_bram) == pytest.approx((0.75, 0.83), abs=1e-6)
    assert got.power_mw == pytest.approx(554.60, rel=1e-3)
    assert got.converged == ref.converged
    assert got.baseline_mw == pytest.approx(ref.baseline_mw, rel=1e-3)
    assert got.saving == pytest.approx(ref.saving, abs=1e-3)
    assert got.t_junct_max == pytest.approx(ref.t_junct_max, abs=2e-2)
    assert got.d_worst_ns == pytest.approx(ref.d_worst_ns, rel=1e-6)


def test_golden_vs():
    r = TVS.run(tvb.load("mkPktMerge"), 60.0, 1.0,
                TT.ThermalConfig(theta_ja=12.0), device="cpu")
    assert r.v_core == pytest.approx(GOLDEN_VS["v_core"], abs=1e-3)
    assert r.v_bram == pytest.approx(GOLDEN_VS["v_bram"], abs=1e-3)
    assert r.power_mw == pytest.approx(GOLDEN_VS["power_mw"], rel=1e-3)
    assert len(r.trace) == GOLDEN_VS["iters"]


def test_golden_eo_and_reference():
    tc_t, tc_j = TT.ThermalConfig(theta_ja=2.0), JT.ThermalConfig(theta_ja=2.0)
    r = TEO.run(tvb.load("mkPktMerge"), 65.0, 1.0, tc_t, device="cpu")
    ref = JEO.run(jvb.load("mkPktMerge"), 65.0, 1.0, tc_j)
    assert r.v_core == pytest.approx(GOLDEN_EO["v_core"], abs=1e-3)
    assert r.v_bram == pytest.approx(GOLDEN_EO["v_bram"], abs=1e-3)
    for k in ("d_opt_ns", "energy", "freq_ratio"):
        assert getattr(r, k) == pytest.approx(GOLDEN_EO[k], rel=1e-3), k
    assert r.saving == pytest.approx(GOLDEN_EO["saving"], abs=1e-3)
    assert r.n_refined == ref.n_refined


def test_energy_opt_guards():
    r = TEO.run(tvb.load("mkPktMerge"), 65.0, 1.0,
                TT.ThermalConfig(theta_ja=2.0), max_iters=0, device="cpu")
    assert r.d_opt_ns > 0 and np.isfinite(r.freq_ratio)
    assert TEO._safe_div(1.0, 0.0, default=1.0) == 1.0


def test_dynamic_lut_matches_reference():
    t_ambs = [10.0, 30.0, 50.0, 70.0, 85.0]
    ref = JVS.dynamic_lut(jvb.load("or1200"), t_ambs,
                          tc=JT.ThermalConfig(theta_ja=12.0))
    got = TVS.dynamic_lut(tvb.load("or1200"), t_ambs,
                          tc=TT.ThermalConfig(theta_ja=12.0), device="cpu")
    assert got == ref


def test_dynamic_lut_equals_sequential_runs():
    nl, tc = tvb.load("mkPktMerge"), TT.ThermalConfig(theta_ja=2.0)
    t_ambs = [10.0, 40.0, 70.0]
    lut = TVS.dynamic_lut(nl, t_ambs, tc=tc, device="cpu")
    sub = tpol.fpga_substrate(nl, tc=tc, device="cpu")
    solver = tpol.cached_solver(sub, tpol.PowerSave(), 0.1, 10,
                                refine_window=TVS.REFINE_WINDOW_V)
    for t in t_ambs:
        vc, vb = sub.decode(solver.solve({"t_amb": t, "act": 1.0}).idx)
        assert lut[t] == (float(vc[0]), float(vb[0]))
    vcs = [lut[t][0] for t in t_ambs]
    assert vcs == sorted(vcs)  # less margin at higher ambient


def test_zero_iterations_clamped():
    r = TVS.run(tvb.load("mkPktMerge"), 60.0, 1.0,
                TT.ThermalConfig(theta_ja=12.0), max_iters=0, device="cpu")
    assert len(r.trace) == 1 and r.power_mw > 0


@pytest.mark.parametrize("entry", ["run", "baseline_power", "dynamic_lut",
                                   "energy_opt", "fpga_substrate"])
def test_entry_point_without_device_needs_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nl, tc = tvb.load("mkPktMerge"), TT.ThermalConfig(theta_ja=12.0)
    calls = {
        "run": lambda: TVS.run(nl, 60.0, 1.0, tc),
        "baseline_power": lambda: TVS.baseline_power(nl, 60.0, 1.0, tc),
        "dynamic_lut": lambda: TVS.dynamic_lut(nl, [25.0], tc=tc),
        "energy_opt": lambda: TEO.run(nl, 65.0, 1.0, tc),
        "fpga_substrate": lambda: tpol.fpga_substrate(nl, tc=tc),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


def test_chip_smoke_lut_table_is_the_reference():
    """``chip_smoke.py`` holds the card's 86-ambient LUT against its
    ``LUT_86`` table (change points) and recomputes 6 ambients with the CPU
    port. The table equals the reference's LUT at every change point and
    the ambient just before it (34 ambients, one batched call), and the
    port's at those 6."""
    import chip_smoke
    want = chip_smoke.lut_86()
    assert sorted(want) == [float(t) for t in range(86)]
    edges = sorted({float(t) for t0, _, _ in chip_smoke.LUT_86
                    for t in (t0 - 1, t0) if t >= 0})
    t_ambs = chip_smoke.LUT_CPU_AMBS
    tc = dict(theta_ja=12.0)
    ref = JVS.dynamic_lut(jvb.load("mkDelayWorker32B"), edges, 1.0,
                          JT.ThermalConfig(**tc))
    got = TVS.dynamic_lut(tvb.load("mkDelayWorker32B"), t_ambs, 1.0,
                          TT.ThermalConfig(**tc), device="cpu")
    assert got == {t: want[t] for t in t_ambs}
    assert {float(t): (float(a), float(b)) for t, (a, b) in ref.items()} \
        == {t: want[t] for t in edges}
