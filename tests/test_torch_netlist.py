"""Device library and netlists: the PyTorch port against the JAX package.

The same numpy inputs go through both packages (JAX on the CPU, the port
with ``device="cpu"``). Tolerances: the element models agree to 1e-6
relative (float32, the same formulas in the same order); path delays and
tile powers to 1e-5 relative (sums over path elements and resources may
round in another order); generated designs are array-equal (both are
numpy-seeded), with ``delay_scale`` to 1e-6 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as JC
from repro.core import netlist as JNL
from repro.core import vtr_benchmarks as jvb
from repro_torch.core import characterization as TC
from repro_torch.core import netlist as TNL
from repro_torch.core import vtr_benchmarks as tvb

ARRAYS = ("used", "total", "tile_act", "path_res", "path_tile")


@pytest.fixture(scope="module")
def grid():
    """A (res, V, T) grid over every class, the rail range and -20..120 C."""
    res, V, T = np.meshgrid(np.arange(JC.N_RESOURCES),
                            np.linspace(0.55, 0.95, 9, dtype=np.float32),
                            np.linspace(-20.0, 120.0, 8, dtype=np.float32),
                            indexing="ij")
    return res.ravel(), V.ravel(), T.ravel()


@pytest.mark.parametrize("model", ["delay", "leakage", "dynamic"])
def test_device_library_matches_reference(grid, model):
    res, V, T = grid
    jlib, tlib = JC.default_library(), TC.default_library()
    act = np.linspace(0.1, 1.0, res.size).astype(np.float32)
    if model == "dynamic":
        ref = jlib.dynamic(jnp.asarray(res), jnp.asarray(V), 0.25,
                           jnp.asarray(act))
        got = tlib.dynamic(torch.as_tensor(res), torch.as_tensor(V), 0.25,
                           torch.as_tensor(act))
    else:
        ref = getattr(jlib, model)(jnp.asarray(res), jnp.asarray(V),
                                   jnp.asarray(T))
        got = getattr(tlib, model)(torch.as_tensor(res), torch.as_tensor(V),
                                   torch.as_tensor(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_activity_models_match_reference():
    a = np.linspace(0.0, 1.0, 41).astype(np.float32)
    for fn in ("internal_activity", "dsp_activity_factor"):
        np.testing.assert_allclose(
            getattr(TC, fn)(torch.as_tensor(a)).numpy(),
            np.asarray(getattr(JC, fn)(jnp.asarray(a))), rtol=1e-6)


@pytest.mark.parametrize("name", ["mkPktMerge", "or1200", "LU8PEEng",
                                  "mkDelayWorker32B"])
def test_generate_equals_reference(name):
    ref, got = jvb.load(name), tvb.load(name)
    assert (got.m, got.n, got.f_base_mhz) == (ref.m, ref.n, ref.f_base_mhz)
    assert (got.n_luts, got.n_brams, got.n_dsps) == (ref.n_luts, ref.n_brams,
                                                      ref.n_dsps)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    assert got.delay_scale == pytest.approx(ref.delay_scale, rel=1e-6)


@pytest.mark.parametrize("name", ["mkPktMerge", "or1200"])
def test_timing_and_power_sweep_match_reference(name):
    jnl = jvb.load(name)
    nl = TNL.netlist_from_reference(dataclasses.asdict(jnl))
    jlib, tlib = JC.default_library(), TC.default_library()
    nlj, nlt = jnl.as_jax(), nl.as_torch("cpu")
    rng = np.random.default_rng(1)
    base = rng.uniform(0.0, 6.0, nl.n_tiles).astype(np.float32)
    for vc, vb, t in [(0.55, 0.55, 25.0), (0.68, 0.83, 60.0),
                      (0.74, 0.79, 85.0), (0.80, 0.95, 100.0)]:
        T = (base + t).astype(np.float32)
        d_ref = float(JNL.crit_delay(jlib, nlj, jnp.asarray(T), vc, vb))
        d_got = float(TNL.crit_delay(tlib, nlt, torch.as_tensor(T), vc, vb))
        assert d_got == pytest.approx(d_ref, rel=1e-5)
        lk_r, dy_r = JNL.tile_power(jlib, nlj, jnp.asarray(T), vc, vb, 0.3, 0.7)
        lk_g, dy_g = TNL.tile_power(tlib, nlt, torch.as_tensor(T), vc, vb,
                                    0.3, 0.7)
        np.testing.assert_allclose(lk_g.numpy(), np.asarray(lk_r), rtol=1e-5)
        np.testing.assert_allclose(dy_g.numpy(), np.asarray(dy_r), rtol=1e-5)
        tot_r = JNL.total_power(jlib, nlj, jnp.asarray(T), vc, vb, 0.3, 0.7)
        tot_g = TNL.total_power(tlib, nlt, torch.as_tensor(T), vc, vb, 0.3,
                                0.7)
        assert float(tot_g) == pytest.approx(float(tot_r), rel=1e-5)


def test_batched_timing_equals_per_element():
    nl = tvb.load("or1200")
    lib, nlt = TC.default_library(), nl.as_torch("cpu")
    rng = np.random.default_rng(2)
    T = torch.as_tensor(rng.uniform(30, 90, (3, nl.n_tiles)),
                        dtype=torch.float32)
    vc = torch.tensor([0.6, 0.7, 0.8])
    vb = torch.tensor([0.7, 0.8, 0.9])
    batched = TNL.crit_delay(lib, nlt, T, vc, vb)
    for i in range(3):
        assert float(batched[i]) == float(
            TNL.crit_delay(lib, nlt, T[i], vc[i], vb[i]))


def test_netlist_from_reference_round_trip():
    ref = jvb.load("or1200")
    nl = TNL.netlist_from_reference(dataclasses.asdict(ref))
    for f in dataclasses.fields(TNL.Netlist):
        a, b = getattr(nl, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a is not b  # an independent copy
        else:
            assert a == b
    assert nl.n_tiles == ref.n_tiles
