"""The §III-B dynamic-scheme lookup structures of the control fast path.

The port of ``repro.control.lut``; the tables are host-side numpy, as the
reference's are (a lookup is a few hundred multiply-adds per control tick,
no device work). Two tiers:

- :class:`RailField` — the control plane's primary fast path: a **per-chip,
  two-axis** table of ``(v_core, v_sram)`` rails over an
  ``ambient x utilization`` knot grid, built by ONE batched ``solve_batch``
  call over the 2-D sweep (``FleetPlanner.rail_field``, on the device) and
  **bilinearly interpolated** at lookup. Ambient is a pod-level scalar;
  utilization may be per chip — each chip interpolates the utilization
  axis at its own sensed load, so a load spike rides the fast path instead
  of forcing a ``util_drift`` replan.
- :class:`DynamicLut` — the legacy scalar facade: the paper's raw
  ``{t_amb: (v_core, v_sram)}`` pod-median table with 1-D linear
  interpolation, clamped at the sweep edges. ``RailField.median_lut()``
  reduces the 2-D table back to exactly this shape (pod median over chips
  at the full-utilization slice).

Rails fall with ambient (colder -> more margin -> lower rails) and rise with
utilization (hotter chip -> less margin), so linear interpolation between
knots errs on the order of the knot spacing times the rail slope.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np

# the canonical default utilization axis — every field constructor (planner,
# runtime, controller) references this one constant so their defaults can
# never drift apart
DEFAULT_UTIL_KNOTS = (0.25, 0.5, 0.75, 1.0)


class DynamicLut:
    """Interpolated ``t_amb -> (v_core, v_sram)`` lookup over a solved sweep.

    ``table`` is the raw dict produced by ``dynamic_lut`` /
    ``FleetPlanner.lut``; knots are sorted internally.  Lookups outside
    ``[t_min, t_max]`` clamp to the edge knots (the solver, not the
    interpolant, is the right tool out there — see
    :meth:`covers` and the controller's guard band).
    """

    def __init__(self, table: Dict[float, Tuple[float, float]]):
        if not table:
            raise ValueError("DynamicLut needs at least one solved knot")
        knots = sorted(table.items())
        self.t = np.asarray([k for k, _ in knots], np.float64)
        self.vc = np.asarray([v[0] for _, v in knots], np.float64)
        self.vs = np.asarray([v[1] for _, v in knots], np.float64)

    # ------------------------------------------------------------------
    @property
    def t_min(self) -> float:
        return float(self.t[0])

    @property
    def t_max(self) -> float:
        return float(self.t[-1])

    def covers(self, t_amb: float, margin: float = 0.0) -> bool:
        """True when ``t_amb`` lies within the solved sweep (± margin)."""
        return (self.t_min - margin) <= t_amb <= (self.t_max + margin)

    def lookup(self, t_amb) -> Tuple[float, float]:
        """Interpolated rails at ``t_amb`` (clamped at the sweep edges).

        Accepts a scalar (returns floats) or an array (returns arrays).
        """
        vc = np.interp(t_amb, self.t, self.vc)  # np.interp clamps at edges
        vs = np.interp(t_amb, self.t, self.vs)
        if np.ndim(t_amb) == 0:
            return float(vc), float(vs)
        return vc, vs

    def as_table(self) -> Dict[float, Tuple[float, float]]:
        """The raw knot table (the legacy ``dynamic_lut`` return shape)."""
        return {float(t): (float(c), float(s))
                for t, c, s in zip(self.t, self.vc, self.vs)}

    def __len__(self) -> int:
        return int(self.t.shape[0])

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"DynamicLut({len(self)} knots, "
                f"[{self.t_min:.1f}C, {self.t_max:.1f}C])")


class RailField:
    """Per-chip bilinear ``(t_amb, util) -> (v_core, v_sram)`` rail tables.

    ``vc``/``vs`` are ``(K_t, K_u, chips)`` tables solved on the
    ``t_knots x u_knots`` grid (each grid point is one full Algorithm-1
    fixed point at uniform utilization ``u``); ``p_nom`` optionally carries
    the per-chip nominal-baseline power on the same grid so readouts can
    interpolate the nominal reference instead of re-solving it.

    Lookups clamp on both axes.  Below ``u_min`` the clamp is conservative
    (rails solved for a *hotter* pod than sensed); above ``u_max`` it is
    not — the controller treats that as a replan trigger, exactly like an
    ambient excursion past the sweep.
    """

    RAIL_STEP_V = 0.010  # one 10 mV rail step: the per-chip trust contract

    def __init__(self, t_knots, u_knots, vc: np.ndarray, vs: np.ndarray,
                 p_nom: Optional[np.ndarray] = None):
        self.t = np.asarray(t_knots, np.float64)
        self.u = np.asarray(u_knots, np.float64)
        if self.t.ndim != 1 or self.t.size == 0:
            raise ValueError("RailField needs >= 1 ambient knot")
        if self.u.ndim != 1 or self.u.size == 0:
            raise ValueError("RailField needs >= 1 utilization knot")
        if np.any(np.diff(self.t) <= 0) or np.any(np.diff(self.u) <= 0):
            raise ValueError("RailField knots must be strictly increasing")
        shape = (self.t.size, self.u.size)
        self.vc = np.asarray(vc, np.float64)
        self.vs = np.asarray(vs, np.float64)
        if self.vc.shape[:2] != shape or self.vc.shape != self.vs.shape \
                or self.vc.ndim != 3:
            raise ValueError(
                f"rail tables must be (K_t, K_u, chips) = {shape} + (D,); "
                f"got vc {self.vc.shape}, vs {self.vs.shape}")
        self.chips = int(self.vc.shape[2])
        self.p_nom = (None if p_nom is None
                      else np.asarray(p_nom, np.float64))
        if self.p_nom is not None and self.p_nom.shape != self.vc.shape:
            raise ValueError("p_nom must match the rail-table shape")
        # observability: lookups that clamped below the utilization axis
        # (conservative, but an excursion worth counting)
        self.clamped_below = 0

    def slice_chips(self, lo: int, hi: int) -> "RailField":
        """A pod's view of the fleet field: chip columns ``[lo, hi)`` of
        every table, same knots.  Bilinear lookup interpolates each chip
        independently, so looking up a slice is bitwise what slicing a
        full-fleet lookup would return (per-pod controllers can share ONE
        ``FleetPlanner.rail_field`` build)."""
        if not (0 <= lo < hi <= self.chips):
            raise ValueError(f"chip slice [{lo}, {hi}) outside the fleet's "
                             f"{self.chips} chips")
        return RailField(
            self.t, self.u, self.vc[:, :, lo:hi], self.vs[:, :, lo:hi],
            p_nom=None if self.p_nom is None else self.p_nom[:, :, lo:hi])

    # ------------------------------------------------------------------
    @property
    def t_min(self) -> float:
        return float(self.t[0])

    @property
    def t_max(self) -> float:
        return float(self.t[-1])

    @property
    def u_min(self) -> float:
        return float(self.u[0])

    @property
    def u_max(self) -> float:
        return float(self.u[-1])

    def covers(self, t_amb: float, margin: float = 0.0) -> bool:
        """Ambient-axis coverage (the controller's LUT-range guard)."""
        return (self.t_min - margin) <= t_amb <= (self.t_max + margin)

    def covers_util(self, util, margin: float = 0.0) -> bool:
        """Utilization-axis coverage.  Only the *upper* edge matters for
        trust: below ``u_min`` the clamped lookup is conservative (rails
        solved at higher utilization than sensed)."""
        return bool(np.max(np.asarray(util)) <= self.u_max + margin)

    # ------------------------------------------------------------------
    @staticmethod
    def _axis_weights(knots: np.ndarray, x) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
        """(lo index, hi index, hi weight) of clamped linear interpolation."""
        x = np.clip(np.asarray(x, np.float64), knots[0], knots[-1])
        hi = np.clip(np.searchsorted(knots, x, side="left"), 1,
                     knots.size - 1) if knots.size > 1 else np.zeros_like(
                         x, np.int64)
        lo = hi - 1 if knots.size > 1 else hi
        if knots.size > 1:
            w = (x - knots[lo]) / (knots[hi] - knots[lo])
        else:
            w = np.zeros_like(x)
        return lo, hi, w

    def _interp(self, tables, t_amb: float,
                util: Union[None, float, np.ndarray]):
        """Bilinear per-chip interpolation of (K_t, K_u, chips) tables at
        ``(t_amb, util[c])`` — the one implementation every lookup shares.
        Both axes clamp; ``util`` broadcasts from None (-> u_max) / scalar
        to per chip."""
        ti, tj, tw = self._axis_weights(self.t, float(t_amb))
        u = np.broadcast_to(
            np.asarray(self.u_max if util is None else util, np.float64),
            (self.chips,))
        ui, uj, uw = self._axis_weights(self.u, u)
        c = np.arange(self.chips)
        out = []
        for tab in tables:
            tab_t = (1.0 - tw) * tab[ti] + tw * tab[tj]  # (K_u, chips)
            out.append((1.0 - uw) * tab_t[ui, c] + uw * tab_t[uj, c])
        return out

    def lookup(self, t_amb: float,
               util: Union[None, float, np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-chip rails at ``(t_amb, util)`` -> two ``(chips,)`` arrays.

        ``util`` may be omitted (full utilization), a pod-level scalar, or a
        per-chip ``(chips,)`` array — each chip interpolates the
        utilization axis at its own value (the cross-chip thermal coupling
        of a *non*-uniform load is the guard band's job; the pinned trust
        contract holds on the solved uniform grid).  Both axes clamp; a
        below-axis utilization clamp increments ``clamped_below`` (the
        rails answered are the conservative ``u_min`` slice).
        """
        if (util is not None and np.size(util)
                and float(np.min(np.asarray(util))) < self.u_min - 1e-9):
            self.clamped_below += 1
        vc, vs = self._interp((self.vc, self.vs), t_amb, util)
        return vc, vs

    def nominal_power(self, t_amb: float,
                      util: Union[None, float, np.ndarray] = None
                      ) -> Optional[np.ndarray]:
        """Interpolated per-chip nominal-baseline power [W] (None when the
        field was built without the baseline grid)."""
        if self.p_nom is None:
            return None
        return self._interp((self.p_nom,), t_amb, util)[0]

    # ------------------------------------------------------------------
    def median_lut(self, u: Optional[float] = None) -> DynamicLut:
        """The pod-median 1-D reduction — the legacy §III-B scalar scheme.

        At the full-utilization slice (``u=None`` -> ``u_max``) this
        reproduces ``FleetPlanner.lut`` / ``dynamic_lut`` exactly when the
        slice sits on a solved knot (same fixed points, median over chips)
        — held equal to the reference in ``tests/test_torch_control.py``.
        """
        k = (int(self.u.size - 1) if u is None
             else int(np.argmin(np.abs(self.u - u))))
        return DynamicLut({
            float(t): (float(np.median(self.vc[i, k])),
                       float(np.median(self.vs[i, k])))
            for i, t in enumerate(self.t)})

    def __len__(self) -> int:
        return int(self.t.size * self.u.size)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"RailField({self.t.size}x{self.u.size} knots x "
                f"{self.chips} chips, [{self.t_min:.1f}C, {self.t_max:.1f}C]"
                f" x [{self.u_min:.2f}, {self.u_max:.2f}] util)")


def sweep_points(lo: float, hi: float, n: int) -> Iterable[float]:
    """Evenly spaced LUT knots over [lo, hi]."""
    return [float(x) for x in np.linspace(lo, hi, n)]
