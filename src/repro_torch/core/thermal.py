"""Steady-state RC thermal grid solver (the HotSpot-6.0 analogue).

The port of ``repro.core.thermal``. The die is the netlist's (m x n) tile
grid; steady state solves

    (G_v + sum_nbr G_lat) T_ij - G_lat * sum_nbr T_nbr = P_ij + G_v * T_amb

with the convective resistance calibrated so 1 W raises the mean junction
temperature by theta_JA.

``solve`` takes a leading batch axis on the power map, the ambient and the
warm start: B independent problems of one grid shape run together, and
each stops on its own criterion. A batch element whose stop test is met is
frozen (its field, residuals and counter keep their values) while the rest
iterate, which is what the reference's ``while_loop`` does under ``vmap``,
so a batched solve equals the per-element solves.

Tiers (``ThermalConfig.solver``): ``"multigrid"`` (red-black Gauss-Seidel
smoothed V-cycles, block-sum restriction, bilinear prolongation, a dense
coarse inverse, full-multigrid cold start) and ``"jacobi"`` (chunked Jacobi,
the parity oracle). Each V-cycle (or Jacobi chunk) ends with one stop test,
which is one host synchronisation on the card: ``solve.host_syncs`` counts
them, and ``solve.calls`` the solves.

The smoother runs the Hopper stencil kernel through
``kernels.ops.thermal_sweep`` (``backend="auto"`` on CUDA, or
``"kernel"``, which refuses a solve on the CPU), or its plain PyTorch
version (``"auto"`` on the CPU, or ``"torch"``). The coarse inverse and the
prolongations are plain dense products (``torch.bmm``, and a
product-and-sum for the coarse inverse).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.thermal_stencil import nbr_sum, thermal_stencil_ref


@dataclass(frozen=True)
class ThermalConfig:
    theta_ja: float = 2.0  # degC/W effective junction-to-ambient resistance
    spreading: float = 25.0  # lateral/vertical conductance ratio (die spread)
    tol: float = 5e-5  # convergence |dT|_inf per sweep/cycle [degC]
    max_iters: int = 50_000  # sweep budget (jacobi tier)
    solver: str = "multigrid"  # "multigrid" | "jacobi"
    # smoother: "auto" (the kernel on CUDA, the plain version on the CPU) |
    # "kernel" (CUDA only: a solve on the CPU raises) | "torch" (plain)
    backend: str = "auto"
    n_smooth: int = 1  # RB-GS pre- and post-smoothing sweeps per V-cycle
    coarse_cells: int = 512  # direct-solve at <= this many cells
    max_cycles: int = 200  # V-cycle budget (multigrid tier)
    check_every: int = 32  # fused sweeps between reduces (jacobi tier)

    def __post_init__(self):
        if self.backend not in ("auto", "kernel", "torch"):
            raise ValueError(f"unknown smoother backend {self.backend!r}")


def conductances(m: int, n: int, tc: ThermalConfig) -> Tuple[float, float]:
    """(G_v per tile [W/degC], G_lat between neighbours)."""
    g_v = 1.0 / (tc.theta_ja * m * n)
    g_lat = g_v * tc.spreading
    return g_v, g_lat


def _diag_np(gv_map: np.ndarray, g_lat: float) -> np.ndarray:
    m, n = gv_map.shape
    nbrc = np.full((m, n), 4.0)
    nbrc[0, :] -= 1
    nbrc[-1, :] -= 1
    nbrc[:, 0] -= 1
    nbrc[:, -1] -= 1
    return gv_map + g_lat * nbrc


def _interp_weights_np(mm: int, mc: int) -> np.ndarray:
    """1D cell-centered linear interpolation matrix (mm x mc).

    Coarse cell j covers fine cells [2j, min(2j+1, mm-1)] (the trailing
    slab of an odd dimension covers one); each fine center interpolates
    between the bracketing coarse-span centers, clamped at the edges.
    """
    centers = np.array([(2 * j + min(2 * j + 1, mm - 1) + 1.0) / 2.0
                        for j in range(mc)])
    W = np.zeros((mm, mc))
    for i in range(mm):
        xi = i + 0.5
        j = int(np.searchsorted(centers, xi))
        if j == 0:
            W[i, 0] = 1.0
        elif j >= mc:
            W[i, mc - 1] = 1.0
        else:
            w = (xi - centers[j - 1]) / (centers[j] - centers[j - 1])
            W[i, j - 1], W[i, j] = 1.0 - w, w
    return W


@lru_cache(maxsize=64)
def _plan_levels(m: int, n: int, g_v: float, g_lat: float,
                 coarse_cells: int):
    """Static multigrid hierarchy (numpy): per-level dims + stencil diagonal
    + prolongation matrices, and the dense inverse of the coarsest-level
    operator (inverted in float64).

    Rediscretization: a coarse cell aggregates its fine cells' vertical
    conductances (block sum), while the lateral conductance between coarse
    cells stays ``g_lat``. The restricted residual is extensive (W per
    cell), so restriction is the block SUM.
    """
    levels = []
    gv = np.full((m, n), g_v, np.float64)
    while True:
        mm, nn = gv.shape
        levels.append([mm, nn, _diag_np(gv, g_lat).astype(np.float32),
                       None, None])
        if mm * nn <= coarse_cells or (mm == 1 and nn == 1):
            break
        mc, nc = (mm + 1) // 2, (nn + 1) // 2
        levels[-1][3] = _interp_weights_np(mm, mc).astype(np.float32)
        levels[-1][4] = _interp_weights_np(nn, nc).astype(np.float32)
        pad = np.zeros((2 * mc, 2 * nc))
        pad[:mm, :nn] = gv
        gv = pad.reshape(mc, 2, nc, 2).sum(axis=(1, 3))

    mm, nn, diag_c = levels[-1][:3]
    A = np.diag(diag_c.reshape(-1).astype(np.float64))
    idx = np.arange(mm * nn).reshape(mm, nn)
    for di, dj in ((1, 0), (0, 1)):
        src = idx[:mm - di, :nn - dj].reshape(-1)
        dst = idx[di:, dj:].reshape(-1)
        A[src, dst] -= g_lat
        A[dst, src] -= g_lat
    A_inv = np.linalg.inv(A).astype(np.float32)
    return tuple(tuple(lv) for lv in levels), A_inv


@lru_cache(maxsize=64)
def _plan_on(m: int, n: int, g_v: float, g_lat: float, coarse_cells: int,
             device: torch.device):
    """``_plan_levels`` as tensors on ``device``: (dims, diags, prolongation
    pairs (Wr, Wc^T), A_inv)."""
    levels, A_inv = _plan_levels(m, n, g_v, g_lat, coarse_cells)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    dims = [tuple(lv[:2]) for lv in levels]
    diags = [t(lv[2]) for lv in levels]
    Ws = [(t(lv[3]), t(lv[4]).T.contiguous()) for lv in levels
          if lv[3] is not None]
    return dims, diags, Ws, t(A_inv)


def _sweeps(T, b, diag, g_lat: float, sweeps: int, phase, tc: ThermalConfig):
    """``sweeps`` stencil sweeps on (B, m, n): red-black starting on red
    (``phase=0``) or Jacobi (``phase=None``). The wrapper dispatches on the
    device itself; ``backend="torch"`` asks for the plain version anywhere."""
    if tc.backend == "torch":
        return thermal_stencil_ref(T, b, diag, g_lat, 0.0, sweeps, phase)
    return ops.thermal_sweep(T, b, diag, g_lat=g_lat, g_v_tamb=0.0,
                             iters=sweeps, phase=phase)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with a 2-D operand broadcast over the batch: every
    batch element is one product of the same shape, so its rounding does not
    depend on the batch size (batched == per-element)."""
    B = max(a.shape[0] if a.dim() == 3 else 1, b.shape[0] if b.dim() == 3 else 1)
    a = a.expand(B, *a.shape[-2:]) if a.dim() == 2 else a
    b = b.expand(B, *b.shape[-2:]) if b.dim() == 2 else b
    return torch.bmm(a, b)


def _restrict(r, mc: int, nc: int):
    """Full-weighting of the extensive residual: 2x2 block sums (zero-padded
    on odd trailing edges, where the coarse cell covers fewer fine cells)."""
    B, m, n = r.shape
    r = F.pad(r, (0, 2 * nc - n, 0, 2 * mc - m))
    return r.reshape(B, mc, 2, nc, 2).sum(dim=(2, 4))


def _sync_any(mask: torch.Tensor) -> bool:
    """Host read of a stop test (one synchronisation on the card)."""
    solve.host_syncs += 1
    return bool(mask.any())


def _solve_multigrid(b, T0, g_v: float, g_lat: float, tc: ThermalConfig):
    B, m, n = b.shape
    dims, diags, Ws, A_inv = _plan_on(m, n, g_v, g_lat,
                                      int(tc.coarse_cells), b.device)

    def coarse_solve(bc):
        mm, nn = bc.shape[-2:]
        # A_inv x as products summed along rows: unlike a matrix-vector
        # product, whose kernel changes with the batch size, each element
        # rounds the same whatever the batch (batched == per-element)
        return (A_inv * bc.reshape(B, 1, -1)).sum(-1).reshape(B, mm, nn)

    def prolong(lvl, e):
        Wr, WcT = Ws[lvl]
        return _bmm(_bmm(Wr, e), WcT)  # cell-centered bilinear prolongation

    def scaled_residual(T):
        """max |r| / diag per element — the |dT|_inf one Jacobi sweep would
        apply at T (the seed solver's stopping metric)."""
        r = b - (diags[0] * T - g_lat * nbr_sum(T))
        return (r.abs() / diags[0]).amax(dim=(1, 2))

    def vcycle(lvl, T, b_l):
        if lvl == len(dims) - 1:
            return coarse_solve(b_l)
        diag = diags[lvl]
        T = _sweeps(T, b_l, diag, g_lat, tc.n_smooth, 0, tc)
        r = b_l - (diag * T - g_lat * nbr_sum(T))
        mc, nc = dims[lvl + 1]
        e = vcycle(lvl + 1, torch.zeros((B, mc, nc), dtype=torch.float32,
                                        device=b.device),
                   _restrict(r, mc, nc))
        T = T + prolong(lvl, e)
        return _sweeps(T, b_l, diag, g_lat, tc.n_smooth, 0, tc)

    if len(dims) == 1:  # the whole grid fits the direct tier: exact solve
        return coarse_solve(b)

    if T0 is None:
        # full-multigrid cold start: solve the restricted problem on the
        # coarsest level exactly, prolongate up with one V-cycle per level
        bs = [b]
        for lvl in range(len(dims) - 1):
            bs.append(_restrict(bs[-1], *dims[lvl + 1]))
        T0 = coarse_solve(bs[-1])
        for lvl in range(len(dims) - 2, -1, -1):
            T0 = vcycle(lvl, prolong(lvl, T0), bs[lvl])

    T = T0
    s_prev = torch.full((B,), float("inf"), device=b.device)
    s = scaled_residual(T)  # 0 cycles for an already-converged warm start
    i = torch.zeros((B,), dtype=torch.int32, device=b.device)
    while True:
        # stop when converged under tol OR stalled at the f32 residual
        # floor; each element stops on its own test and stays frozen
        active = (s > tc.tol) & (s < 0.9 * s_prev) & (i < tc.max_cycles)
        if not _sync_any(active):
            return T
        T_new = vcycle(0, T, b)
        s_new = scaled_residual(T_new)
        T = torch.where(active[:, None, None], T_new, T)
        s_prev = torch.where(active, s, s_prev)
        s = torch.where(active, s_new, s)
        i = i + active.to(torch.int32)


def _solve_jacobi(b, T0, g_v: float, g_lat: float, tc: ThermalConfig):
    B, m, n = b.shape
    diag = torch.as_tensor(_diag_np(np.full((m, n), g_v), g_lat),
                           dtype=torch.float32, device=b.device)
    K = max(int(tc.check_every), 1)
    T = T0
    err = torch.full((B,), float("inf"), device=b.device)
    i = torch.zeros((B,), dtype=torch.int64, device=b.device)
    while True:
        active = (err > tc.tol) & (i < tc.max_iters)
        if not _sync_any(active):
            return T
        # K-1 fused sweeps, then one measured sweep: the reduce compares
        # consecutive sweeps — the seed criterion at chunk granularity
        T_mid = _sweeps(T, b, diag, g_lat, K - 1, None, tc)
        T_new = _sweeps(T_mid, b, diag, g_lat, 1, None, tc)
        e_new = (T_new - T_mid).abs().amax(dim=(1, 2))
        T = torch.where(active[:, None, None], T_new, T)
        err = torch.where(active, e_new, err)
        i = i + K * active.to(torch.int64)


def solve(power_mw, m: int, n: int, t_amb, tc: ThermalConfig = ThermalConfig(),
          T0=None, device=None):
    """power_mw: (m*n,) or (B, m*n) per-tile power in mW -> temperatures
    [degC] of the same shape.

    ``t_amb`` is a scalar or (B,). ``T0`` ((m*n,), (m, n), (B, m*n) or
    (B, m, n)) warm-starts the iteration; the default is the full-multigrid
    cold start (multigrid tier) or the seed's analytic estimate (jacobi).
    """
    dev = resolve_device(device)
    if tc.backend == "kernel" and dev.type != "cuda":
        raise ValueError("ThermalConfig(backend='kernel') needs a CUDA "
                         f"device; the solve runs on {dev}")
    solve.calls += 1
    P = torch.as_tensor(power_mw, dtype=torch.float32, device=dev)
    batched = P.dim() == 2
    P = P.reshape(-1, m, n) * 1e-3  # W
    g_v, g_lat = conductances(m, n, tc)
    t_amb = torch.as_tensor(t_amb, dtype=torch.float32, device=dev)
    batched = batched or t_amb.dim() == 1
    t_amb = t_amb.reshape(-1, 1, 1)
    b = P + g_v * t_amb
    B = b.shape[0]
    if T0 is not None:
        T0 = torch.as_tensor(T0, dtype=torch.float32, device=dev)
        T0 = T0.reshape(-1, m, n).expand(B, m, n)

    if tc.solver == "multigrid":
        T = _solve_multigrid(b, T0, g_v, g_lat, tc)
    elif tc.solver == "jacobi":
        if T0 is None:  # the seed's analytic warm start
            T0 = t_amb.expand(B, m, n) + P / g_v * 0.5
        T = _solve_jacobi(b, T0, g_v, g_lat, tc)
    else:
        raise ValueError(f"unknown thermal solver {tc.solver!r}")
    return T.reshape(B, m * n) if batched else T.reshape(m * n)


solve.calls = 0  # calls of solve (one batched solve counts once)
solve.host_syncs = 0  # stop-test reads, one per V-cycle or Jacobi chunk
