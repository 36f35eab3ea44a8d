"""Substrate protocol — the device a thermal-aware policy optimizes.

The port of ``repro.policy.substrate``: :class:`FpgaNetlistSubstrate` (the
paper's placed-and-routed designs) and :class:`TpuFleetSubstrate` (the pod
re-parameterisation of ``core/tpu_fleet.py``). A :class:`Substrate` is what
Algorithm 1/2 need to know about a piece of silicon: a site grid ``(m, n)``
with a :class:`~repro_torch.core.thermal.ThermalConfig`, ``D`` selection
domains, a flat grid of ``C`` candidate operating points with the nominal
point at ``nominal_idx``, and the physics: per-candidate delay at a
temperature field (``cand_delay``), per-candidate domain power
(``cand_power``) and the per-site power of a chosen selection
(``site_power``), against the timing reference ``d_worst``.

Every method takes a leading batch axis: ``T_sites`` is (B, S), ``env``
leaves are (B,) (the pod's per-chip ``util`` is (B, D)), candidate arrays
are (B, D, C) and selections (B, D).

The candidate evaluation runs in chunks of the candidate axis so that no
intermediate exceeds ``CHUNK_ELEMS`` elements (the reference evaluates one
candidate at a time under ``vmap`` and never holds the whole
(candidates, tiles, resources) product); each element is computed by the
same formula and reduced in the same order (over resources, then tiles).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import characterization as C
from repro_torch.core import netlist as NL
from repro_torch.core import thermal
from repro_torch.core import tpu_fleet as TF
from repro_torch.core.netlist import Netlist

# degC guard on timing eval (TSD error / spatial gradients, paper §III-B)
T_GUARD = 2.0

# the paper's Algorithm-1 voltage mesh (10 mV steps)
V_CORE_GRID = np.round(np.arange(0.55, 0.801, 0.01), 3)
V_BRAM_GRID = np.round(np.arange(0.55, 0.951, 0.01), 3)

#: largest intermediate of the chunked candidate evaluation, in float32
#: elements: 256 MiB on the card, 16 MiB (cache-sized) on the CPU
CHUNK_ELEMS = {"cuda": 1 << 26, "cpu": 1 << 22}

Env = Dict[str, torch.Tensor]


@runtime_checkable
class Substrate(Protocol):
    """Structural protocol; see the module docstring for the contract."""

    grid: Tuple[int, int]
    thermal_cfg: thermal.ThermalConfig
    n_domains: int
    n_candidates: int
    nominal_idx: int
    f_nom: float
    f_cap: float
    device: torch.device

    @property
    def d_worst(self) -> float: ...

    def T0(self, env: Env) -> torch.Tensor: ...
    def cand_delay(self, T_sites, env: Env) -> torch.Tensor: ...
    def cand_power(self, T_sites, f, env: Env) -> torch.Tensor: ...
    def site_power(self, T_sites, idx, f_sel, env: Env) -> torch.Tensor: ...
    def delay_at(self, T_sites, idx, env: Env) -> torch.Tensor: ...
    def power_at(self, T_sites, idx, f_sel, env: Env) -> torch.Tensor: ...
    def window_mask(self, idx_prev, window: float) -> torch.Tensor: ...
    def exec_time(self, f) -> torch.Tensor: ...
    def nominal_only(self) -> "Substrate": ...


def _chunks(total: int, per_item: int, device: torch.device):
    """Slices of ``range(total)`` of at most CHUNK_ELEMS / per_item items."""
    step = max(1, CHUNK_ELEMS.get(device.type, 1 << 22) // max(per_item, 1))
    return [slice(s, min(s + step, total)) for s in range(0, total, step)]


# =============================================================================
# FPGA netlist substrate (Algorithm 1/2 on the paper's designs)
# =============================================================================

class FpgaNetlistSubstrate:
    """One placed-and-routed design; a single (V_core, V_bram) domain.

    ``env`` keys: ``t_amb`` (ambient degC), ``act`` (primary-input activity).
    Delay is evaluated at ``T + T_GUARD`` (paper §III-B guard), power at T.
    """

    def __init__(self, netlist: Netlist,
                 lib: Optional[C.DeviceLibrary] = None,
                 tc: thermal.ThermalConfig = thermal.ThermalConfig(),
                 v_core_grid=None, v_bram_grid=None,
                 _d_worst: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.netlist = netlist
        self.lib = lib or C.default_library()
        self.thermal_cfg = tc
        self.grid = (netlist.m, netlist.n)
        self.nlt = netlist.as_torch(self.device)
        vc = np.asarray(V_CORE_GRID if v_core_grid is None else v_core_grid,
                        np.float32)
        vb = np.asarray(V_BRAM_GRID if v_bram_grid is None else v_bram_grid,
                        np.float32)
        VC, VB = np.meshgrid(vc, vb, indexing="ij")
        self.vc_np, self.vb_np = VC.reshape(-1), VB.reshape(-1)
        self.vc_flat = torch.as_tensor(self.vc_np, device=self.device)
        self.vb_flat = torch.as_tensor(self.vb_np, device=self.device)
        self.n_domains = 1
        self.n_candidates = int(self.vc_np.shape[0])
        nom = (np.abs(self.vc_np - C.V_CORE_NOM)
               + np.abs(self.vb_np - C.V_BRAM_NOM))
        self.nominal_idx = int(np.argmin(nom))
        self._d_worst = _d_worst
        self._nominal = None
        self.f_cap = np.inf  # Algorithm 2 may overclock past f_base
        res = self.nlt["path_res"]
        self._path_valid = res >= 0
        self._path_res = torch.clamp(res, min=0)
        self._res_ids = torch.arange(C.N_RESOURCES, device=self.device)
        self._total_rs = self.nlt["total"].T.contiguous()  # (R, S)
        self._used_rs = self.nlt["used"].T.contiguous()

    @property
    def d_worst(self) -> float:
        """STA at (T_MAX, nominal rails) [ns] — the guardbanded clock."""
        if self._d_worst is None:
            T = torch.full((self.netlist.n_tiles,), C.T_MAX,
                           dtype=torch.float32, device=self.device)
            self._d_worst = float(NL.crit_delay(
                self.lib, self.nlt, T, C.V_CORE_NOM, C.V_BRAM_NOM))
        return self._d_worst

    @property
    def f_nom(self) -> float:
        return 1.0 / self.d_worst  # GHz; the clock stays at d_worst

    def T0(self, env: Env) -> torch.Tensor:
        t = env["t_amb"].to(torch.float32)
        return t[:, None].expand(-1, self.netlist.n_tiles).clone()

    def cand_delay(self, T_sites, env: Env) -> torch.Tensor:
        """Critical delay of every candidate: (B, S) -> (B, 1, C)."""
        lib, res, valid = self.lib, self._path_res, self._path_valid
        T_elem = (T_sites + T_GUARD)[:, self.nlt["path_tile"]]  # (B, P, L)
        vth, mu = lib.delay_T_terms(res, T_elem)
        B = T_sites.shape[0]
        out = []
        for sl in _chunks(self.n_candidates, B * res.numel(), self.device):
            V = NL._rails(res, self.vc_flat[sl], self.vb_flat[sl])  # (c, P, L)
            d = lib.delay_from_terms(res, V[None], vth[:, None], mu[:, None])
            d = self.nlt["delay_scale"] * torch.where(valid, d, 0.0).sum(-1)
            out.append(d.amax(-1))  # (B, c)
        return torch.cat(out, dim=1)[:, None, :]

    def cand_power(self, T_sites, f, env: Env) -> torch.Tensor:
        """Total power of every candidate at clock ``f`` (B, 1, C):
        (B, S) -> (B, 1, C)."""
        # the products run on (B, c, R, S) so that the long tile axis is
        # innermost; each element is tile_power's, summed over R then S
        lib, res_ids = self.lib, self._res_ids
        B, S = T_sites.shape
        lkg_T = lib.leakage_T(res_ids[:, None], T_sites[:, None, :])  # (B,R,S)
        act_res = NL.activity_per_resource(env["act"])[:, None, :]  # (B,1,R)
        f = torch.broadcast_to(f, (B, 1, self.n_candidates))[:, 0]  # (B, C)
        out = []
        for sl in _chunks(self.n_candidates, B * S * C.N_RESOURCES,
                          self.device):
            V_res = NL._rails(res_ids, self.vc_flat[sl], self.vb_flat[sl])
            v_ratio, v_exp = lib.leakage_V(res_ids, V_res)  # (c, R)
            lkg_e = (lkg_T[:, None] * v_ratio[None, :, :, None]
                     * v_exp[None, :, :, None])  # (B, c, R, S)
            p_lkg = (self._total_rs * lkg_e).sum(-2)  # (B, c, S)
            dyn_e = lib.dynamic(res_ids, V_res[None], f[:, sl, None],
                                act_res)  # (B, c, R)
            p_dyn = ((self._used_rs * dyn_e[..., None]).sum(-2)
                     * self.nlt["tile_act"])
            out.append(p_lkg.sum(-1) + p_dyn.sum(-1))  # (B, c)
        return torch.cat(out, dim=1)[:, None, :]

    def site_power(self, T_sites, idx, f_sel, env: Env) -> torch.Tensor:
        """Per-tile power of the chosen candidates: (B, S) [mW]."""
        lkg, dyn = NL.tile_power(self.lib, self.nlt, T_sites,
                                 self.vc_flat[idx[:, 0]],
                                 self.vb_flat[idx[:, 0]], f_sel[:, 0],
                                 env["act"])
        return lkg + dyn

    def delay_at(self, T_sites, idx, env: Env) -> torch.Tensor:
        d = NL.crit_delay(self.lib, self.nlt, T_sites + T_GUARD,
                          self.vc_flat[idx[:, 0]], self.vb_flat[idx[:, 0]])
        return d[:, None]

    def power_at(self, T_sites, idx, f_sel, env: Env) -> torch.Tensor:
        return self.site_power(T_sites, idx, f_sel, env).sum(-1)[:, None]

    def window_mask(self, idx_prev, window: float) -> torch.Tensor:
        """Paper's O(1) refinement: candidates within ±window V of the
        previous solution on both rails. (B, 1) -> (B, 1, C)."""
        vc_p = self.vc_flat[idx_prev[:, 0]][:, None]
        vb_p = self.vb_flat[idx_prev[:, 0]][:, None]
        m = (((self.vc_flat[None] - vc_p).abs() <= window)
             & ((self.vb_flat[None] - vb_p).abs() <= window))
        return m[:, None, :]

    def exec_time(self, f) -> torch.Tensor:
        return 1.0 / f  # one clock period [ns]

    def nominal_only(self) -> "FpgaNetlistSubstrate":
        if self._nominal is None:
            self._nominal = FpgaNetlistSubstrate(
                self.netlist, self.lib, self.thermal_cfg,
                v_core_grid=[C.V_CORE_NOM], v_bram_grid=[C.V_BRAM_NOM],
                _d_worst=self.d_worst, device=self.device)
        return self._nominal

    def decode(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate index -> (v_core, v_bram) as numpy."""
        idx = np.asarray(idx)
        return self.vc_np[idx], self.vb_np[idx]


# =============================================================================
# TPU fleet substrate (the pod re-parameterisation)
# =============================================================================

class TpuFleetSubstrate:
    """A (m x n)-chip pod; every chip is its own selection domain.

    ``env`` keys: ``t_amb`` (B,), ``util`` (per-chip utilization scale,
    (B, D)). ``d_worst`` is the *relative* step-time contract 1.0: a
    candidate is feasible when its worst pipeline delay factor stays within
    gamma of it. The candidate math is the reference's float32 formulas on
    the substrate's device.
    """

    def __init__(self, prof: TF.StepProfile,
                 lib: Optional[TF.TpuLibrary] = None,
                 grid: Tuple[int, int] = (16, 16),
                 theta_chip: float = 0.20,
                 tc: Optional[thermal.ThermalConfig] = None,
                 v_core_grid=None, v_sram_grid=None,
                 warm_offset: float = 25.0, device=None):
        self.device = resolve_device(device)
        self.prof = prof
        self.lib = lib or TF.TpuLibrary()
        self.grid = grid
        self.thermal_cfg = tc or TF.pod_thermal_config(theta_chip,
                                                       grid[0] * grid[1])
        vc = np.asarray(
            np.arange(0.55, TF.V_CORE_NOM + 0.001, 0.01)
            if v_core_grid is None else v_core_grid, np.float32)
        vs = np.asarray(
            np.arange(0.60, TF.V_SRAM_NOM + 0.001, 0.01)
            if v_sram_grid is None else v_sram_grid, np.float32)
        VC, VS = np.meshgrid(vc, vs, indexing="ij")
        self.vc_np, self.vs_np = VC.reshape(-1), VS.reshape(-1)
        self.vc_flat = torch.as_tensor(self.vc_np, device=self.device)
        self.vs_flat = torch.as_tensor(self.vs_np, device=self.device)
        self.n_domains = grid[0] * grid[1]
        self.n_candidates = int(self.vc_np.shape[0])
        nom = (np.abs(self.vc_np - TF.V_CORE_NOM)
               + np.abs(self.vs_np - TF.V_SRAM_NOM))
        self.nominal_idx = int(np.argmin(nom))
        self.warm_offset = warm_offset
        self._nominal = None
        self.f_nom = 1.0
        self.f_cap = 1.0  # the pod never overclocks past the rated step

    @property
    def d_worst(self) -> float:
        return 1.0  # the step-time contract, in relative units

    def T0(self, env: Env) -> torch.Tensor:
        """The cold-start field: (D,) for a scalar ``t_amb``, (B, D) for a
        (B,) batch."""
        t = torch.as_tensor(env["t_amb"], dtype=torch.float32,
                            device=self.device)
        return (t[..., None].expand(*t.shape, self.n_domains)
                + self.warm_offset)

    def cand_delay(self, T_sites, env: Env) -> torch.Tensor:
        """Worst relative pipeline delay 1/f_max per (chip, candidate):
        (B, D) -> (B, D, C)."""
        Tg = T_sites[..., None] + T_GUARD
        fmax = TF.f_max_rel(self.lib, self.vc_flat, self.vs_flat, Tg)
        return 1.0 / fmax

    def cand_power(self, T_sites, f, env: Env) -> torch.Tensor:
        p = TF.chip_power(self.lib, self.prof, self.vc_flat, self.vs_flat, f,
                          T_sites[..., None])
        return p * env["util"][..., None]  # (B, D, C) [W]

    def site_power(self, T_sites, idx, f_sel, env: Env) -> torch.Tensor:
        p = TF.chip_power(self.lib, self.prof, self.vc_flat[idx],
                          self.vs_flat[idx], f_sel, T_sites)
        return p * env["util"] * 1e3  # (B, D) [mW] for the thermal solver

    def delay_at(self, T_sites, idx, env: Env) -> torch.Tensor:
        fmax = TF.f_max_rel(self.lib, self.vc_flat[idx], self.vs_flat[idx],
                            T_sites + T_GUARD)
        return 1.0 / fmax

    def power_at(self, T_sites, idx, f_sel, env: Env) -> torch.Tensor:
        p = TF.chip_power(self.lib, self.prof, self.vc_flat[idx],
                          self.vs_flat[idx], f_sel, T_sites)
        return p * env["util"]

    def window_mask(self, idx_prev, window: float) -> torch.Tensor:
        vc_p = self.vc_flat[idx_prev][..., None]
        vs_p = self.vs_flat[idx_prev][..., None]
        return (((self.vc_flat - vc_p).abs() <= window)
                & ((self.vs_flat - vs_p).abs() <= window))

    def exec_time(self, f) -> torch.Tensor:
        """Relative step time when the core clock runs at f x nominal."""
        scal = self.prof.f_scalable
        return scal / f + (1.0 - scal)

    def nominal_only(self) -> "TpuFleetSubstrate":
        if self._nominal is None:
            self._nominal = TpuFleetSubstrate(
                self.prof, self.lib, self.grid, tc=self.thermal_cfg,
                v_core_grid=[TF.V_CORE_NOM], v_sram_grid=[TF.V_SRAM_NOM],
                warm_offset=self.warm_offset, device=self.device)
        return self._nominal

    def decode(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate index -> (v_core, v_sram) as numpy."""
        idx = np.asarray(idx)
        return self.vc_np[idx], self.vs_np[idx]


# =============================================================================
# substrate caches (repeated run() calls share substrates and their STA)
# =============================================================================

_CACHE_LIMIT = 16  # LRU bound: a netlist sweep must not pin memory forever
_FPGA_CACHE: "OrderedDict" = OrderedDict()
_TPU_CACHE: "OrderedDict" = OrderedDict()


def _lru_get(cache, key, make):
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    val = cache[key] = make()
    if len(cache) > _CACHE_LIMIT:
        cache.popitem(last=False)
    return val


def fpga_substrate(netlist: Netlist, lib=None,
                   tc: thermal.ThermalConfig = thermal.ThermalConfig(),
                   device=None) -> FpgaNetlistSubstrate:
    """Memoized substrate, keyed by netlist identity (netlists are cached by
    ``vtr_benchmarks.load``), library and thermal config by value, and the
    device."""
    dev = resolve_device(device)
    lib = lib or C.default_library()
    key = (id(netlist), lib, tc, str(dev))
    return _lru_get(_FPGA_CACHE, key,
                    lambda: FpgaNetlistSubstrate(netlist, lib, tc, device=dev))


def tpu_substrate(prof: TF.StepProfile, lib=None,
                  grid: Tuple[int, int] = (16, 16),
                  theta_chip: float = 0.20,
                  device=None) -> TpuFleetSubstrate:
    """Memoized pod substrate, keyed by profile, library, grid, theta and
    the device."""
    dev = resolve_device(device)
    lib = lib or TF.TpuLibrary()
    key = (prof, lib, grid, theta_chip, str(dev))
    return _lru_get(_TPU_CACHE, key,
                    lambda: TpuFleetSubstrate(prof, lib, grid, theta_chip,
                                              device=dev))
