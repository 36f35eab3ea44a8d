"""The port's plain thermal stencil against the JAX package's stencil.

The JAX side runs as its own tests run it: the Pallas kernel in interpret
mode and the ``kref.thermal_stencil_ref`` oracle. The port runs on CPU
tensors, where the wrapper takes the plain version. Tolerance: 1e-5
relative (both are float32 and evaluate the same expression in the same
order; XLA may still fuse differently). A batch of grids must equal the
per-grid results exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import thermal as JT
from repro.kernels import ref as kref
from repro.kernels.thermal_stencil import thermal_stencil as jax_stencil
from repro_torch.core import thermal as TT
from repro_torch.kernels import ops
from repro_torch.kernels import thermal_stencil as TS

RTOL = 1e-5
ITERS = 5


def _inputs(m, n, B=None, seed=11):
    g_v, g_lat = JT.conductances(m, n, JT.ThermalConfig(theta_ja=12.0))
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    T = rng.uniform(25, 40, lead + (m, n)).astype(np.float32)
    P = rng.uniform(0, 5e-3, lead + (m, n)).astype(np.float32)
    diag = JT._diag_np(np.full((m, n), g_v), g_lat).astype(np.float32)
    return T, P, diag, g_lat, g_v * 25.0


@pytest.mark.parametrize("m,n", [(1, 1), (3, 5), (23, 17), (92, 92)])
@pytest.mark.parametrize("phase", [None, 0, 1])
def test_plain_matches_jax(m, n, phase):
    T, P, diag, g_lat, g_vt = _inputs(m, n)
    got = ops.thermal_sweep(torch.as_tensor(T), torch.as_tensor(P),
                            torch.as_tensor(diag), g_lat=g_lat,
                            g_v_tamb=g_vt, iters=ITERS, phase=phase).numpy()
    ref = np.asarray(kref.thermal_stencil_ref(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(diag), g_lat, g_vt,
        ITERS, phase=phase))
    ker = np.asarray(jax_stencil(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(diag), g_lat=g_lat,
        g_v_tamb=g_vt, iters=ITERS, phase=phase, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_allclose(got, ker, rtol=RTOL)


@pytest.mark.parametrize("phase", [None, 0, 1])
def test_batch_equals_per_grid(phase):
    T, P, diag, g_lat, g_vt = _inputs(23, 17, B=3)
    Tt, Pt, Dt = map(torch.as_tensor, (T, P, diag))
    batched = TS.thermal_stencil(Tt, Pt, Dt, g_lat=g_lat, g_v_tamb=g_vt,
                                 iters=ITERS, phase=phase)
    for b in range(3):
        one = TS.thermal_stencil(Tt[b], Pt[b], Dt, g_lat=g_lat,
                                 g_v_tamb=g_vt, iters=ITERS, phase=phase)
        assert torch.equal(batched[b], one)


def test_cpu_tensor_takes_plain_version_without_launch():
    T, P, diag, g_lat, g_vt = _inputs(8, 8)
    before = TS.thermal_stencil.launches
    out = TS.thermal_stencil(torch.as_tensor(T), torch.as_tensor(P),
                             torch.as_tensor(diag), g_lat=g_lat,
                             g_v_tamb=g_vt, iters=3, phase=0)
    ref = TS.thermal_stencil_ref(torch.as_tensor(T), torch.as_tensor(P),
                                 torch.as_tensor(diag), g_lat, g_vt, 3, 0)
    assert torch.equal(out, ref)
    assert TS.thermal_stencil.launches == before


def test_red_black_differs_from_jacobi():
    """The colours are sequential: the second sees the first's update."""
    T, P, diag, g_lat, g_vt = map(
        lambda x: torch.as_tensor(x) if isinstance(x, np.ndarray) else x,
        _inputs(8, 8))
    rb = TS.thermal_stencil_ref(T, P, diag, g_lat, g_vt, 1, 0)
    ja = TS.thermal_stencil_ref(T, P, diag, g_lat, g_vt, 1, None)
    assert float((rb - ja).abs().max()) > 0


def test_smoother_backend_choice(monkeypatch):
    """"auto" and "kernel" go through the wrapper (which dispatches on the
    device), "torch" takes the plain version on any device; an unknown
    backend is refused when the config is made."""
    seen = []
    monkeypatch.setattr(ops, "thermal_sweep",
                        lambda *a, **k: seen.append(1) or a[0])
    T, P, diag, g_lat, _ = (torch.as_tensor(x) if isinstance(x, np.ndarray)
                            else x for x in _inputs(8, 8, B=1))
    for backend, via_wrapper in (("auto", True), ("kernel", True),
                                 ("torch", False)):
        seen.clear()
        tc = TT.ThermalConfig(backend=backend)
        out = TT._sweeps(T, P, diag, g_lat, 2, 0, tc)
        assert bool(seen) == via_wrapper
        if not via_wrapper:
            assert torch.equal(out, TS.thermal_stencil_ref(
                T, P, diag, g_lat, 0.0, 2, 0))
    with pytest.raises(ValueError):
        TT.ThermalConfig(backend="pallas")


@pytest.mark.parametrize("iters,phase,resident,expected",
                         [(31, 0, True, 1), (31, None, True, 1),
                          (5, 1, False, 10), (5, None, False, 5)])
def test_launch_count_per_call(iters, phase, resident, expected):
    """The counter counts kernel launches: one for the fused resident
    shape, one per colour half-sweep or Jacobi sweep for the global one."""
    assert TS.kernel_launches(iters, phase, resident) == expected
