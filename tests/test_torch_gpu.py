"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card: ``pytest -m gpu tests/test_torch_gpu.py``.
Without one every test here skips (the ``cuda`` fixture decides, at run
time). The stencil kernel rounds every operation as the plain version does,
so the two must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import thermal
from repro_torch.kernels import thermal_stencil as TS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, n, B, device, seed=11):
    g_v, g_lat = thermal.conductances(m, n, thermal.ThermalConfig(theta_ja=12.0))
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    T = torch.tensor(rng.uniform(25, 40, (B, m, n)), **f32)
    P = torch.tensor(rng.uniform(0, 5e-3, (B, m, n)), **f32)
    diag = torch.tensor(thermal._diag_np(np.full((m, n), g_v), g_lat), **f32)
    return T, P, diag, g_lat, g_v * 25.0


@pytest.mark.parametrize("m,n", [(1, 1), (23, 17), (23, 23), (38, 38),
                                 (46, 46), (76, 76), (92, 92), (152, 152),
                                 (256, 256)])
@pytest.mark.parametrize("phase", [None, 0, 1])
@pytest.mark.parametrize("B", [1, 3])
def test_kernel_equals_plain(cuda, m, n, phase, B):
    T, P, diag, g_lat, g_vt = _inputs(m, n, B, cuda)
    before = TS.thermal_stencil.launches
    out = TS.thermal_stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_vt, iters=5,
                             phase=phase)
    ref = TS.thermal_stencil_ref(T, P, diag, g_lat, g_vt, 5, phase)
    torch.cuda.synchronize()
    resident = TS.is_resident(m, n, phase, cuda)
    assert resident == (m * n < 256 * 256)
    assert TS.thermal_stencil.launches == before + TS.kernel_launches(
        5, phase, resident)
    assert torch.equal(out, ref)


def test_two_dim_call_and_per_element_p(cuda):
    T, P, diag, g_lat, g_vt = _inputs(23, 23, 2, cuda)
    full = TS.thermal_stencil(T, P, diag, g_lat=g_lat, g_v_tamb=g_vt,
                              iters=3, phase=0)
    one = TS.thermal_stencil(T[1], P[1], diag, g_lat=g_lat, g_v_tamb=g_vt,
                             iters=3, phase=0)
    assert torch.equal(full[1], one)


def test_rejects_bad_input(cuda):
    T, P, diag, g_lat, g_vt = _inputs(8, 8, 1, cuda)
    with pytest.raises(ValueError):
        TS.thermal_stencil(T.double(), P, diag, g_lat=g_lat, g_v_tamb=g_vt,
                           iters=1, phase=0)
    with pytest.raises(ValueError):
        TS.thermal_stencil(T, P[:, :4], diag, g_lat=g_lat, g_v_tamb=g_vt,
                           iters=1, phase=0)


def test_solve_kernel_backend_matches_torch_backend(cuda):
    m = n = 92
    rng = np.random.default_rng(3)
    P = rng.uniform(0.0, 5.0, (2, m * n))
    T_k = thermal.solve(P, m, n, [25.0, 60.0],
                        thermal.ThermalConfig(theta_ja=12.0, backend="kernel"),
                        device=cuda)
    T_t = thermal.solve(P, m, n, [25.0, 60.0],
                        thermal.ThermalConfig(theta_ja=12.0, backend="torch"),
                        device=cuda)
    assert torch.equal(T_k, T_t)
