"""Abstract placed-and-routed design model (the VPR output analogue).

The port of ``repro.core.netlist``. A :class:`Netlist` keeps its numpy
fields exactly as the reference does; ``as_torch(device)`` puts them on a
device. Designs are generated from a numpy seed, so the port regenerates
the reference's benchmarks array for array.

Timing and power take any leading batch axes on the temperature field and
the rails: ``path_delays`` / ``crit_delay`` / ``tile_power`` broadcast
``T_tiles (..., tiles)`` against ``v_core``, ``v_bram``, ``f_ghz`` and
``act_in`` of shape ``(...)``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, fields
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import characterization as C

# per-CLB-tile effective element counts (COFFE-like tile composition)
TILE_LUT = 10
TILE_SB = 30
TILE_CB = 15
TILE_LOCAL = 25
TILE_FF = 10


@dataclass
class Netlist:
    name: str
    m: int  # rows
    n: int  # cols
    # per-tile resource counts, shape (m*n, N_RESOURCES): *used* resources
    used: np.ndarray
    # per-tile total (used + unused leak too), shape (m*n, N_RESOURCES)
    total: np.ndarray
    # per-tile activity scale in [0,1] (multiplies the design-level activity)
    tile_act: np.ndarray
    # timing paths: (P, L) int arrays; res_class = -1 marks padding
    path_res: np.ndarray
    path_tile: np.ndarray
    f_base_mhz: float  # paper-reported base frequency at worst case
    n_luts: int = 0
    n_brams: int = 0
    n_dsps: int = 0
    delay_scale: float = 1.0  # calibrates CP delay to 1000/f_base_mhz

    @property
    def n_tiles(self) -> int:
        return self.m * self.n

    def as_torch(self, device) -> Dict[str, torch.Tensor]:
        dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "used": torch.as_tensor(self.used, **f32),
            "total": torch.as_tensor(self.total, **f32),
            "tile_act": torch.as_tensor(self.tile_act, **f32),
            "path_res": torch.as_tensor(self.path_res, dtype=torch.long,
                                        device=dev),
            "path_tile": torch.as_tensor(self.path_tile, dtype=torch.long,
                                         device=dev),
            "delay_scale": torch.tensor(self.delay_scale, **f32),
        }


def netlist_from_reference(fields_: dict) -> Netlist:
    """Build the port's netlist from the reference's fields (the dict that
    ``dataclasses.asdict`` gives for a ``repro.core.netlist.Netlist``)."""
    names = {f.name for f in fields(Netlist)}
    kw = {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
          for k, v in fields_.items() if k in names}
    return Netlist(**kw)


# =============================================================================
# timing & power (the T / P_lkg / P_dyn of Algorithm 1)
# =============================================================================

def _rails(lib_res: torch.Tensor, v_core, v_bram):
    """Per-element rail voltage: v_bram on BRAM elements, else v_core.
    ``lib_res``: class ids (..., K); the rails broadcast over (...)."""
    vc = torch.as_tensor(v_core, dtype=torch.float32, device=lib_res.device)
    vb = torch.as_tensor(v_bram, dtype=torch.float32, device=lib_res.device)
    pad = (None,) * lib_res.dim()
    return torch.where(lib_res == C.BRAM, vb[(...,) + pad],
                       vc[(...,) + pad])


def path_delays(lib: C.DeviceLibrary, nl: Dict[str, torch.Tensor],
                T_tiles, v_core, v_bram):
    """Delay of every path [ns]: T_tiles (..., tiles), rails (...) ->
    (..., P). Padding elements (res=-1) contribute 0."""
    res = nl["path_res"]  # (P, L)
    valid = res >= 0
    res_c = torch.clamp(res, min=0)
    T_elem = T_tiles[..., nl["path_tile"]]  # (..., P, L)
    V_elem = _rails(res_c, v_core, v_bram)
    d = lib.delay(res_c, V_elem, T_elem)
    return nl["delay_scale"] * torch.where(valid, d, 0.0).sum(-1)


def crit_delay(lib, nl, T_tiles, v_core, v_bram):
    return path_delays(lib, nl, T_tiles, v_core, v_bram).amax(-1)


def activity_per_resource(act_in) -> torch.Tensor:
    """(..., R) toggle activity per resource class: the internal activity,
    with the DSP's own saturating curve."""
    act_in = torch.as_tensor(act_in, dtype=torch.float32)
    act_int = C.internal_activity(act_in)
    act_res = act_int[..., None].repeat_interleave(C.N_RESOURCES, -1)
    act_res[..., C.DSP] = C.dsp_activity_factor(act_in)
    act_res[..., C.BRAM] = act_int
    return act_res


def tile_power(lib: C.DeviceLibrary, nl: Dict[str, torch.Tensor],
               T_tiles, v_core, v_bram, f_ghz, act_in):
    """(P_lkg, P_dyn) per tile [mW], each (..., tiles). Leakage counts *all*
    resources (used and unused); dynamic counts used resources at the
    internal activity level."""
    T_tiles = torch.as_tensor(T_tiles, dtype=torch.float32)
    dev = T_tiles.device
    res_ids = torch.arange(C.N_RESOURCES, device=dev)
    V_res = _rails(res_ids, v_core, v_bram)  # (..., R)
    lkg_e = lib.leakage(res_ids, V_res[..., None, :],
                        T_tiles[..., :, None])  # (..., tiles, R)
    p_lkg = (nl["total"] * lkg_e).sum(-1)
    act_res = activity_per_resource(torch.as_tensor(act_in, device=dev))
    f = torch.as_tensor(f_ghz, dtype=torch.float32, device=dev)[..., None]
    dyn_e = lib.dynamic(res_ids, V_res, f, act_res)  # (..., R)
    p_dyn = (nl["used"] * dyn_e[..., None, :]).sum(-1) * nl["tile_act"]
    return p_lkg, p_dyn


def total_power(lib, nl, T_tiles, v_core, v_bram, f_ghz, act_in):
    lkg, dyn = tile_power(lib, nl, T_tiles, v_core, v_bram, f_ghz, act_in)
    return lkg.sum(-1) + dyn.sum(-1)


# =============================================================================
# synthetic design generation from benchmark statistics
# =============================================================================

@dataclass(frozen=True)
class BenchStats:
    """Published-shape statistics for one benchmark (see vtr_benchmarks.py)."""
    name: str
    n_luts: int
    n_brams: int
    n_dsps: int
    f_mhz: float  # VPR frequency at worst case
    cp_profile: str  # 'routing' | 'logic' | 'mixed' | 'memory'
    grid: Optional[Tuple[int, int]] = None
    bram_path_ratio: float = 0.6  # longest-BRAM-path delay / CP delay
    n_paths: int = 256


def _cp_composition(profile: str, rng) -> Dict[int, int]:
    """Element counts of a near-critical path for a given profile."""
    if profile == "routing":
        base = {C.LUT: 6, C.SB: 14, C.CB: 6, C.LOCAL: 5, C.FF: 2}
    elif profile == "logic":
        base = {C.LUT: 12, C.SB: 6, C.CB: 5, C.LOCAL: 8, C.FF: 2}
    elif profile == "memory":
        base = {C.LUT: 5, C.SB: 8, C.CB: 4, C.LOCAL: 4, C.FF: 2}
    else:  # mixed
        base = {C.LUT: 9, C.SB: 10, C.CB: 5, C.LOCAL: 6, C.FF: 2}
    return base


def generate(stats: BenchStats, seed: int = 0) -> Netlist:
    """Deterministic design from benchmark statistics (host numpy; the
    delay model runs on CPU tensors)."""
    # zlib.crc32, not hash(): PYTHONHASHSEED must not change the benchmarks
    rng = np.random.default_rng(seed + zlib.crc32(stats.name.encode()))
    # --- grid size: CLB tiles to hold the LUTs at ~60% packing + BRAM/DSP cols
    if stats.grid:
        m, n = stats.grid
    else:
        n_clb = int(stats.n_luts / (TILE_LUT * 0.6))
        side = int(np.ceil(np.sqrt(n_clb * 1.3)))
        m = n = max(side, 8)
    n_tiles = m * n

    # --- column types: every 8th column BRAM, every 12th DSP (Stratix-like)
    col_type = np.zeros(n, dtype=int)  # 0 CLB, 1 BRAM, 2 DSP
    col_type[4::8] = 1
    col_type[7::12] = 2

    total = np.zeros((n_tiles, C.N_RESOURCES), np.float32)
    used = np.zeros((n_tiles, C.N_RESOURCES), np.float32)
    tile_act = np.zeros(n_tiles, np.float32)

    tile_idx = np.arange(n_tiles).reshape(m, n)
    clb_tiles = tile_idx[:, col_type == 0].ravel()
    bram_tiles = tile_idx[:, col_type == 1].ravel()[::6]  # BRAM height 6 tiles
    dsp_tiles = tile_idx[:, col_type == 2].ravel()[::4]  # DSP height 4 tiles

    # capacity
    total[clb_tiles, C.LUT] = TILE_LUT
    total[clb_tiles, C.SB] = TILE_SB
    total[clb_tiles, C.CB] = TILE_CB
    total[clb_tiles, C.LOCAL] = TILE_LOCAL
    total[clb_tiles, C.FF] = TILE_FF
    total[bram_tiles, C.BRAM] = 1
    total[bram_tiles, C.SB] = TILE_SB  # routing exists in hard columns too
    total[dsp_tiles, C.DSP] = 1
    total[dsp_tiles, C.SB] = TILE_SB

    # placement: used resources clustered in a centered region (VPR-like)
    n_clb_used = min(int(np.ceil(stats.n_luts / TILE_LUT)), len(clb_tiles))
    center = np.array([m / 2, n / 2])
    coords = np.stack(np.unravel_index(clb_tiles, (m, n)), 1)
    order = np.argsort(((coords - center) ** 2).sum(1)
                       + rng.uniform(0, m, len(clb_tiles)))
    place = clb_tiles[order[:n_clb_used]]
    used[place, C.LUT] = TILE_LUT
    used[place, C.SB] = TILE_SB * 0.7
    used[place, C.CB] = TILE_CB * 0.7
    used[place, C.LOCAL] = TILE_LOCAL * 0.6
    used[place, C.FF] = TILE_FF * 0.8
    ub = bram_tiles[:min(stats.n_brams, len(bram_tiles))]
    used[ub, C.BRAM] = 1
    ud = dsp_tiles[:min(stats.n_dsps, len(dsp_tiles))]
    used[ud, C.DSP] = 1
    tile_act[place] = rng.uniform(0.6, 1.0, len(place))
    tile_act[ub] = rng.uniform(0.7, 1.0, len(ub))
    tile_act[ud] = rng.uniform(0.7, 1.0, len(ud))

    # --- paths: near-critical population + BRAM/DSP paths
    comp = _cp_composition(stats.cp_profile, rng)
    L = sum(comp.values()) + 2
    P = stats.n_paths
    path_res = -np.ones((P, L), np.int64)
    path_tile = np.zeros((P, L), np.int64)

    def fill_path(i, elems, tiles_pool, length_scale):
        seq = []
        for r, cnt in elems.items():
            seq += [r] * max(int(round(cnt * length_scale)), 1)
        rng.shuffle(seq)
        seq = seq[:L]
        path_res[i, :len(seq)] = seq
        # a path traverses a contiguous neighborhood of tiles
        start = tiles_pool[rng.integers(len(tiles_pool))]
        si, sj = np.unravel_index(start, (m, n))
        for e in range(len(seq)):
            di, dj = rng.integers(-2, 3), rng.integers(-2, 3)
            ti = np.clip(si + di + e // 3, 0, m - 1)
            tj = np.clip(sj + dj, 0, n - 1)
            path_tile[i, e] = ti * n + tj

    n_bram_paths = max(P // 8, 4) if stats.n_brams else 0
    n_dsp_paths = max(P // 16, 2) if stats.n_dsps else 0
    for i in range(P):
        if i < n_bram_paths:
            elems = dict(_cp_composition("memory", rng))
            elems[C.BRAM] = 1
            scale = stats.bram_path_ratio * rng.uniform(0.85, 1.0)
            pool = ub if len(ub) else place
        elif i < n_bram_paths + n_dsp_paths:
            elems = dict(_cp_composition("mixed", rng))
            elems[C.DSP] = 1
            scale = rng.uniform(0.5, 0.8)
            pool = ud if len(ud) else place
        else:
            elems = comp
            # near-critical population: top path at 1.0, tail down to 0.7
            scale = 1.0 if i == P - 1 else rng.uniform(0.7, 1.0)
            pool = place
        fill_path(i, elems, pool, scale)

    # --- enforce path-delay structure at worst case -------------------------
    # hard-block paths must sit at their published ratio of the soft CP;
    # trim soft elements of hard paths until they fit, using worst-case
    # element delays.
    lib = C.default_library()
    res_ids = np.arange(C.N_RESOURCES)
    v_elem = np.where(res_ids == C.BRAM, C.V_BRAM_NOM, C.V_CORE_NOM)
    d_elem = lib.delay(torch.as_tensor(res_ids),
                       torch.as_tensor(v_elem, dtype=torch.float32),
                       torch.tensor(C.T_MAX, dtype=torch.float32)).numpy()

    def wc_delay(i):
        r = path_res[i]
        return d_elem[np.maximum(r, 0)][r >= 0].sum()

    soft = [i for i in range(P)
            if not np.any(np.isin(path_res[i], (C.BRAM, C.DSP)))]
    d_cp = max(wc_delay(i) for i in soft)
    for i in range(P):
        r = path_res[i]
        if np.any(r == C.BRAM):
            target = d_cp * stats.bram_path_ratio * rng.uniform(0.9, 1.0)
        elif np.any(r == C.DSP):
            target = d_cp * rng.uniform(0.5, 0.8)
        else:
            continue
        # drop soft elements (keep hard block) until within target
        order = [e for e in range(L)
                 if r[e] >= 0 and r[e] not in (C.BRAM, C.DSP)]
        rng.shuffle(order)
        for e in order:
            if wc_delay(i) <= target:
                break
            path_res[i, e] = -1

    nl = Netlist(
        name=stats.name, m=m, n=n, used=used, total=total, tile_act=tile_act,
        path_res=path_res, path_tile=path_tile, f_base_mhz=stats.f_mhz,
        n_luts=stats.n_luts, n_brams=stats.n_brams, n_dsps=stats.n_dsps,
    )
    # calibrate absolute delay so worst-case CP matches the published f_max
    d_raw = float(crit_delay(
        lib, nl.as_torch("cpu"),
        torch.full((n_tiles,), C.T_MAX, dtype=torch.float32),
        C.V_CORE_NOM, C.V_BRAM_NOM))
    nl.delay_scale = (1000.0 / stats.f_mhz) / d_raw
    return nl
