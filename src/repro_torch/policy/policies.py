"""Policy objects — the paper's three objectives over one substrate.

The port of ``repro.policy.policies``. A :class:`Policy` declares, over the
substrate's candidate grid,

- ``frequency``: the clock each candidate would run at,
- ``feasible``:  the timing constraint (vs the substrate's ``d_worst``),
- ``objective``: the quantity the Solver minimizes per selection domain.

All three are tensor math that broadcasts over the Solver's
``(batch, domains, candidates)`` arrays; ``env`` leaves are shaped to
broadcast against them. ``gamma`` (and ``budget`` for
:class:`ErrorTolerant`) is read from ``env`` when present, so sweeps over
them batch through ``Solver.solve_batch``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# --- §V escaped-SDC rate model ----------------------------------------------
SDC_RATE0 = 2e-4   # per-MAC rate scale at the critical point
SDC_RATE_K = 28.0  # sharpness of the rise past the critical point
#: fraction of injected SDCs the ABFT row/column checksums cannot repair
ABFT_ESCAPE = 0.02


def escaped_sdc_rate(x):
    """Predicted escaped-SDC rate per MAC behind ABFT at overshoot ``x``:
    monotone in ``x`` and exactly zero for ``x <= 0``."""
    x = torch.clamp(torch.as_tensor(x, dtype=torch.float32), min=0.0)
    return ABFT_ESCAPE * SDC_RATE0 * torch.expm1(SDC_RATE_K * x)


def overshoot_budget(budget):
    """Inverse of :func:`escaped_sdc_rate`: the largest timing overshoot
    whose predicted escaped rate still fits ``budget`` (0 at budget 0)."""
    b = torch.clamp(torch.as_tensor(budget, dtype=torch.float32), min=0.0)
    return torch.log1p(b / (ABFT_ESCAPE * SDC_RATE0)) / SDC_RATE_K


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class Policy:
    """Base: feasibility at gamma, nominal clock, minimize power."""

    gamma: float = 1.0
    #: which ratio the fleet runtime reports as "saving"
    metric: str = "power"  # "power" | "energy"
    #: route infeasible domains to the nominal candidate (Algorithm 1's
    #: "no margin at this temperature -> stay at nominal rails")
    nominal_fallback: bool = True

    def _gamma(self, env, like):
        return env.get("gamma", _f32(self.gamma, like))

    def frequency(self, sub, d, env):
        """Clock per (domain, candidate); constraint policies hold f_nom."""
        return torch.broadcast_to(_f32(sub.f_nom, d), d.shape)

    def feasible(self, sub, d, env):
        return d <= sub.d_worst * self._gamma(env, d) * (1.0 + 1e-6)

    def objective(self, sub, d, p, f, env):
        return p


@dataclass(frozen=True)
class PowerSave(Policy):
    """Algorithm 1 — minimum power at the guardbanded clock."""


@dataclass(frozen=True)
class Overscale(Policy):
    """§III-D — Algorithm 1 with the timing budget relaxed by gamma >= 1."""

    gamma: float = 1.2


@dataclass(frozen=True)
class MinEnergy(Policy):
    """Algorithm 2 — run each candidate at its own f_max, minimize P x t."""

    metric: str = "energy"
    nominal_fallback: bool = False

    def frequency(self, sub, d, env):
        f = sub.f_nom * sub.d_worst / d
        return torch.clamp(f, max=sub.f_cap)

    def feasible(self, sub, d, env):
        return torch.ones_like(d, dtype=torch.bool)

    def objective(self, sub, d, p, f, env):
        return p * sub.exec_time(f)


@dataclass(frozen=True)
class ErrorTolerant(Policy):
    """§V — Algorithm 1 under an accuracy budget instead of a guard band:
    ``delay <= (1 + overshoot_budget(budget)) * d_worst``. ``budget=0``
    reproduces :class:`PowerSave` rails exactly."""

    budget: float = 0.0

    def _gamma(self, env, like):
        b = env.get("budget", _f32(self.budget, like))
        return 1.0 + overshoot_budget(b)


def from_spec(spec) -> Policy:
    """Parse the CLI/runtime policy spec: 'power_save' | 'min_energy' |
    'overscale:<gamma>' | 'error_tolerant:<budget>' — or pass a Policy
    instance through unchanged."""
    if isinstance(spec, Policy):
        return spec
    if spec == "power_save":
        return PowerSave()
    if spec == "min_energy":
        return MinEnergy()
    if spec.startswith("overscale:"):
        try:
            gamma = float(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"overscale spec needs a numeric gamma, e.g. "
                f"'overscale:1.2'; got {spec!r}") from None
        return Overscale(gamma=gamma)
    if spec.startswith("error_tolerant"):
        try:
            budget = (float(spec.split(":", 1)[1]) if ":" in spec else 0.0)
        except ValueError:
            raise ValueError(
                f"error_tolerant spec needs a numeric escaped-SDC budget, "
                f"e.g. 'error_tolerant:1e-5'; got {spec!r}") from None
        return ErrorTolerant(budget=budget)
    raise ValueError(f"unknown energy policy spec: {spec!r}")
