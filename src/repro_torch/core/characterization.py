"""Characterized (temperature, voltage) -> (delay, power) resource library.

The port of ``repro.core.characterization``: the same alpha-power-law delay
and exponential-leakage models with the same calibrated constants, on
float32 tensors. Each formula is evaluated in the reference's operation
order, so the port rounds as the reference does.

The delay and leakage models are also offered split into a part that
depends only on temperature and a part that depends on voltage
(``delay_T_terms`` / ``delay_from_terms``, ``leakage_T`` / ``leakage_V``).
The candidate search evaluates the temperature part once per field and the
voltage part per candidate; the split performs the identical operations, so
its results equal ``delay`` and ``leakage`` bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

# Resource class ids (order matters: arrays below are indexed by these)
LUT, SB, CB, LOCAL, FF, BRAM, DSP = range(7)
RESOURCE_NAMES = ["LUT", "SB", "CB", "LOCAL", "FF", "BRAM", "DSP"]
N_RESOURCES = 7

T_MAX = 100.0  # junction upper bound [degC] (paper footnote 2)
V_CORE_NOM = 0.80
V_BRAM_NOM = 0.95
V_MIN = 0.55  # BRAM crash floor; also core sweep floor
KELVIN = 273.15


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class DeviceLibrary:
    """Per-resource device constants (len-7 tuples, indexed by class id)."""

    d0: Tuple[float, ...]
    vth0: Tuple[float, ...]
    alpha: Tuple[float, ...]
    mu_exp: Tuple[float, ...]
    vth_kappa: float = 0.0008
    p_dyn0: Tuple[float, ...] = ()
    p_lkg0: Tuple[float, ...] = ()
    lkg_T: float = 0.015
    lkg_eta: Tuple[float, ...] = ()
    dyn_vexp: Tuple[float, ...] = ()
    v_nom: Tuple[float, ...] = ()

    def _arr(self, name: str, res: torch.Tensor) -> torch.Tensor:
        """The per-element constant ``name`` gathered at class ids ``res``."""
        return _f32(getattr(self, name), res)[res]

    # --- delay ---------------------------------------------------------------
    def delay_T_terms(self, res, T):
        """(vth, mu): the temperature-dependent factors of ``delay``."""
        T = _f32(T, res)
        vth = self._arr("vth0", res) + self.vth_kappa * (T_MAX - T)
        mu = torch.pow((T + KELVIN) / (T_MAX + KELVIN),
                       -self._arr("mu_exp", res))
        return vth, mu

    def delay_from_terms(self, res, V, vth, mu):
        """Element delay [ns] from the voltage and the ``delay_T_terms``."""
        V = _f32(V, res)
        d0 = self._arr("d0", res)
        vth0 = self._arr("vth0", res)
        alpha = self._arr("alpha", res)
        vnom = self._arr("v_nom", res)
        vov = torch.clamp(V - vth, min=0.02)
        d_nom = (vnom / 1.0) / torch.pow(vnom - vth0, alpha)
        d = (V / 1.0) / (mu * torch.pow(vov, alpha))
        return d0 * d / d_nom

    def delay(self, res, V, T):
        """Element delay [ns]. res: int tensor of class ids; V, T broadcast."""
        vth, mu = self.delay_T_terms(res, T)
        return self.delay_from_terms(res, V, vth, mu)

    # --- power ----------------------------------------------------------------
    def leakage_T(self, res, T):
        """Temperature factor of ``leakage``: p_lkg0 * e^{lkg_T (T - 25)}."""
        T = _f32(T, res)
        return self._arr("p_lkg0", res) * torch.exp(self.lkg_T * (T - 25.0))

    def leakage_V(self, res, V):
        """Voltage factors of ``leakage``: (V / vnom, e^{eta (V - vnom)})."""
        V = _f32(V, res)
        vnom = self._arr("v_nom", res)
        return V / vnom, torch.exp(self._arr("lkg_eta", res) * (V - vnom))

    def leakage(self, res, V, T):
        """Static power [mW] per element."""
        v_ratio, v_exp = self.leakage_V(res, V)
        return self.leakage_T(res, T) * v_ratio * v_exp

    def dynamic(self, res, V, f_ghz, act):
        """Dynamic power [mW] per element at toggle activity ``act``."""
        V = _f32(V, res)
        p0 = self._arr("p_dyn0", res)
        k = self._arr("dyn_vexp", res)
        vnom = self._arr("v_nom", res)
        return p0 * _f32(act, res) * _f32(f_ghz, res) * torch.pow(V / vnom, k)


# --- activity models (Fig. 3) --------------------------------------------------

def internal_activity(alpha_in):
    """Average internal-node activity for primary-input activity alpha_in."""
    return 0.27 * torch.pow(torch.as_tensor(alpha_in, dtype=torch.float32),
                            0.732)


def dsp_activity_factor(alpha_in):
    """DSP dynamic-power multiplier vs input activity (saturating bump)."""
    a = torch.as_tensor(alpha_in, dtype=torch.float32)
    rise = torch.clamp(a / 0.3, 0.0, 1.0)
    decline = torch.clamp((a - 0.7) / 0.3, 0.0, 1.0) * 0.07
    return (1.0 + 0.37 * rise - decline) / 1.37


# --- the calibrated 22nm-PTM-like library ---------------------------------------

def default_library() -> DeviceLibrary:
    """Constants calibrated against the paper's Fig. 2 / leakage facts (the
    reference's values, unchanged)."""
    return DeviceLibrary(
        #      LUT    SB     CB     LOCAL  FF     BRAM   DSP
        d0=(0.180, 0.220, 0.190, 0.090, 0.065, 1.100, 2.300),
        vth0=(0.467, 0.500, 0.495, 0.495, 0.495, 0.620, 0.495),
        alpha=(0.939, 0.506, 0.600, 0.638, 0.600, 0.758, 0.626),
        mu_exp=(1.563, 1.430, 1.447, 1.418, 1.381, 1.155, 1.406),
        p_dyn0=(0.100, 0.154, 0.072, 0.033, 0.038, 30.0, 22.4),
        p_lkg0=(0.0010, 0.00066, 0.00044, 0.00022, 0.00011, 0.055, 0.33),
        lkg_eta=(7.0, 7.0, 7.0, 7.0, 7.0, 9.0, 7.0),
        dyn_vexp=(2.0, 2.0, 2.0, 2.0, 2.0, 2.6, 2.1),
        v_nom=(V_CORE_NOM,) * 5 + (V_BRAM_NOM, V_CORE_NOM),
    )
