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
coarse inverse, full-multigrid cold start; ``kernels/thermal_mg``) and
``"jacobi"`` (chunked Jacobi, the parity oracle). ``solve.calls`` counts
the solves and ``solve.host_syncs`` the stop tests read on the host.

Where the multigrid solve runs:

- on the card, when the hierarchy fits one CTA's shared memory (every grid
  of the FPGA paths, up to 152x152): the fused kernel
  ``thermal_mg.thermal_mg_solve``, one launch per solve with the V-cycles
  and the stop test on the device, no host read;
- on the card, when it does not (256x256): the plain composition
  ``thermal_mg_solve_ref`` with the stencil kernel as smoother and one
  stop-test read per V-cycle; ``solve.composed`` counts these solves (the
  choice is made by shape, before any launch);
- on the CPU, or with ``backend="torch"``: the plain composition with the
  stencil's plain version;
- grids of at most ``coarse_cells`` cells: one direct product, no cycles.

The Jacobi tier's sweeps run the stencil kernel through
``kernels.ops.thermal_sweep`` on the card (``backend="auto"`` or
``"kernel"``, which refuses a solve on the CPU), with one stop-test read
per chunk.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import thermal_mg as MG
from repro_torch.kernels.thermal_stencil import thermal_stencil_ref


@dataclass(frozen=True)
class ThermalConfig:
    theta_ja: float = 2.0  # degC/W effective junction-to-ambient resistance
    spreading: float = 25.0  # lateral/vertical conductance ratio (die spread)
    tol: float = 5e-5  # convergence |dT|_inf per sweep/cycle [degC]
    max_iters: int = 50_000  # sweep budget (jacobi tier)
    solver: str = "multigrid"  # "multigrid" | "jacobi"
    # "auto" (the kernels on CUDA, their plain versions on the CPU) |
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


def _table_np(W: np.ndarray):
    """(index, weight) form of a 1-D interpolation matrix (mm x mc): each
    row's at most two non-zero weights and their columns, (mm, 2) each; a
    row with one weight repeats its column with weight 0."""
    idx = np.zeros((W.shape[0], 2), np.int64)
    w = np.zeros((W.shape[0], 2), np.float32)
    for i, row in enumerate(W):
        cols = np.flatnonzero(row)
        idx[i] = cols[0], cols[-1]
        w[i, :len(cols)] = row[cols]
    return idx, w


@lru_cache(maxsize=64)
def _plan_levels(m: int, n: int, g_v: float, g_lat: float,
                 coarse_cells: int):
    """Static multigrid hierarchy (numpy): per level (m, n, stencil
    diagonal, row table, column table), the tables the (index, weight) form
    of the prolongation from the next level (None on the last level), and
    the dense inverse of the coarsest-level operator (inverted in float64).

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
        levels[-1][3] = _table_np(_interp_weights_np(mm, mc).astype(np.float32))
        levels[-1][4] = _table_np(_interp_weights_np(nn, nc).astype(np.float32))
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
             device: torch.device) -> MG.Plan:
    """``_plan_levels`` as a ``thermal_mg.Plan`` on ``device`` (the plain
    version's tensors and the kernel's flat copies and shared-memory
    layout)."""
    levels, A_inv = _plan_levels(m, n, g_v, g_lat, coarse_cells)
    return MG.make_plan([lv[:2] for lv in levels], [lv[2] for lv in levels],
                        [lv[3:] for lv in levels[:-1]], A_inv, g_lat, device)


def _sweeps(T, b, diag, g_lat: float, sweeps: int, phase, tc: ThermalConfig):
    """``sweeps`` stencil sweeps on (B, m, n): red-black starting on red
    (``phase=0``) or Jacobi (``phase=None``). The wrapper dispatches on the
    device itself; ``backend="torch"`` asks for the plain version anywhere."""
    if tc.backend == "torch":
        return thermal_stencil_ref(T, b, diag, g_lat, 0.0, sweeps, phase)
    return ops.thermal_sweep(T, b, diag, g_lat=g_lat, g_v_tamb=0.0,
                             iters=sweeps, phase=phase)


def _sync_any(mask: torch.Tensor) -> bool:
    """Host read of a stop test (one synchronisation on the card)."""
    solve.host_syncs += 1
    return bool(mask.any())


def _solve_multigrid(b, T0, g_v: float, g_lat: float, tc: ThermalConfig):
    B, m, n = b.shape
    plan = _plan_on(m, n, g_v, g_lat, int(tc.coarse_cells), b.device)
    if len(plan.dims) == 1:  # the whole grid fits the direct tier: exact solve
        # A_inv x as products summed along rows: unlike a matrix-vector
        # product, whose kernel changes with the batch size, each element
        # rounds the same whatever the batch (batched == per-element)
        return (plan.a_inv * b.reshape(B, 1, -1)).sum(-1).reshape(B, m, n)
    kw = dict(tol=float(tc.tol), max_cycles=int(tc.max_cycles),
              n_smooth=int(tc.n_smooth))
    if b.device.type == "cuda" and tc.backend != "torch":
        if MG.fits(plan, b.device):  # one launch, no host read
            return MG.thermal_mg_solve(b, T0, plan, **kw)[0]
        solve.composed += 1  # too large for one CTA: the per-step form
    return MG.thermal_mg_solve_ref(
        b, T0, plan, any_active=_sync_any,
        smooth=lambda T, b_l, diag: _sweeps(T, b_l, diag, g_lat,
                                            tc.n_smooth, 0, tc), **kw)[0]


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
        T0 = T0.reshape(-1, m, n).expand(B, m, n).contiguous()

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
# multigrid solves on the card whose plan does not fit one CTA's shared
# memory (the per-step form, the stencil kernel as smoother)
solve.composed = 0
