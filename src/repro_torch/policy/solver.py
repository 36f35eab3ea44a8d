"""The shared fixed-point Solver (search -> thermal solve -> repeat).

The port of ``repro.policy.solver``. One engine runs Algorithm 1
(PowerSave), Algorithm 2 (MinEnergy) and over-scaling; specialization lives
in the :class:`Policy` and the :class:`Substrate`. One iteration:

    d      = substrate.cand_delay(T)            # (B, domains, candidates)
    f      = policy.frequency(d)                #   "
    p      = substrate.cand_power(T, f)         #   "
    idx    = argmin over feasible candidates    # (B, domains)
    T_new  = thermal.solve(site_power(idx), T0=T)  # (B, sites) warm-started
    done   = ||T_new - T||_inf < delta_t

Every call runs a batch of environments along a leading axis (``solve`` is
a batch of one). The loop is a Python loop over that batch: an element
whose fixed point has converged (or run out of iterations) keeps every
state leaf as it was, while the others iterate, so a batched result equals
the sequential ones. Each iteration ends with one host read of the
``done`` flags.

``solve_batch(..., early_freeze=True)`` runs the batch in segments of a
few iterations and compacts converged elements out between segments
(padded to power-of-two buckets capped at the batch), so they stop paying
for the candidate search. The per-element arithmetic is the same as in the
lockstep path; the decisions (chosen candidates, iteration counts,
convergence flags, per-iteration choice history) agree with it.

Results come back as numpy arrays, as the reference returns them.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import thermal
from repro_torch.policy.policies import Policy
from repro_torch.policy.substrate import Env, Substrate


class Solution(NamedTuple):
    """Converged operating point; every leaf gains a leading batch axis
    under :meth:`Solver.solve_batch`."""

    idx: np.ndarray        # (D,)  chosen candidate per domain
    f: np.ndarray          # (D,)  chosen clock at the last search
    power: np.ndarray      # (D,)  domain power at the last search T
    obj: np.ndarray        # (D,)  objective value at the last search
    T: np.ndarray          # (S,)  converged temperature field
    n_iters: np.ndarray    # ()    fixed-point iterations performed
    converged: np.ndarray  # ()    bool
    d_final: np.ndarray    # (D,)  delay of the choice at the converged T
    f_final: np.ndarray    # (D,)  clock of the choice at the converged T
    p_final: np.ndarray    # (D,)  domain power of the choice at converged T
    idx_hist: np.ndarray   # (I, D) per-iteration choices
    p_hist: np.ndarray     # (I,)  per-iteration total power
    tj_hist: np.ndarray    # (I,)  per-iteration mean junction temperature


class _State(NamedTuple):
    T: torch.Tensor         # (B, S)
    it: torch.Tensor        # (B,)
    idx: torch.Tensor       # (B, D)
    f_sel: torch.Tensor     # (B, D)
    p_sel: torch.Tensor     # (B, D)
    obj_sel: torch.Tensor   # (B, D)
    done: torch.Tensor      # (B,)
    idx_hist: torch.Tensor  # (B, I, D)
    p_hist: torch.Tensor    # (B, I)
    tj_hist: torch.Tensor   # (B, I)


def _where_rows(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``a`` on the batch rows where ``mask``, else ``b``."""
    return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def _policy_env(env: Env, ndim: int) -> Env:
    """``env`` leaves reshaped to broadcast against (B, ...) of ``ndim``."""
    return {k: v.reshape(-1, *([1] * (ndim - 1))) for k, v in env.items()}


class Solver:
    """Fixed point of (policy, substrate) over a batch; reusable.

    ``refine_window`` (volts) enables the paper's O(1) refinement: after the
    first iteration the search is masked to a +-window neighbourhood of the
    previous solution. The nominal fallback ignores the window.
    """

    def __init__(self, substrate: Substrate, policy: Policy,
                 delta_t: float = 0.1, max_iters: int = 10,
                 refine_window: Optional[float] = None):
        if max_iters < 1:  # guard: a zero-iteration loop has no solution
            max_iters = 1
        self.substrate = substrate
        self.policy = policy
        substrate.d_worst  # compute the cached STA once, up front
        self.delta_t = float(delta_t)
        self.max_iters = int(max_iters)
        self.refine_window = refine_window
        self.host_syncs = 0  # done-flag reads of the fixed-point loops

    # ------------------------------------------------------------------
    def _select(self, T, it, idx_prev, env: Env):
        """One grid search at temperature fields T -> (idx, f, p, obj)."""
        sub, pol = self.substrate, self.policy
        penv = _policy_env(env, 3)
        d = sub.cand_delay(T, env)                      # (B, D, C)
        f = pol.frequency(sub, d, penv)                 # (B, D, C)
        p = sub.cand_power(T, f, env)                   # (B, D, C)
        feas = pol.feasible(sub, d, penv)               # (B, D, C)
        if self.refine_window is not None:
            wmask = sub.window_mask(idx_prev, self.refine_window)
            feas = feas & (wmask | (it == 0)[:, None, None])
        obj = pol.objective(sub, d, p, f, penv)
        obj_m = torch.where(feas, obj, torch.inf)
        idx = torch.argmin(obj_m, dim=-1)               # (B, D)
        if pol.nominal_fallback:
            ok = feas.any(dim=-1)
            idx = torch.where(ok, idx, sub.nominal_idx)
        take = lambda a: torch.gather(
            torch.broadcast_to(a, obj.shape), -1, idx[..., None])[..., 0]
        return idx, take(f), take(p), take(obj)

    def _body(self, env: Env, st: _State) -> _State:
        """One fixed-point iteration (select -> thermal -> convergence)."""
        sub = self.substrate
        m, n = sub.grid
        idx, f_sel, p_sel, obj_sel = self._select(st.T, st.it, st.idx, env)
        sp = sub.site_power(st.T, idx, f_sel, env)
        # warm-start the multigrid solve from the previous iteration's field
        T_new = thermal.solve(sp, m, n, env["t_amb"], sub.thermal_cfg, st.T,
                              device=sp.device)
        dT = (T_new - st.T).abs().amax(-1)
        rows = torch.arange(st.T.shape[0], device=st.T.device)
        slot = torch.clamp(st.it, max=self.max_iters - 1).long()
        idx_hist = st.idx_hist.clone()
        idx_hist[rows, slot] = idx
        p_hist = st.p_hist.clone()
        p_hist[rows, slot] = p_sel.sum(-1)
        tj_hist = st.tj_hist.clone()
        tj_hist[rows, slot] = T_new.mean(-1)
        new = _State(
            T=T_new, it=st.it + 1, idx=idx, f_sel=f_sel, p_sel=p_sel,
            obj_sel=obj_sel, done=dT < self.delta_t,
            idx_hist=idx_hist, p_hist=p_hist, tj_hist=tj_hist)
        # an element that has converged or run out of iterations keeps its
        # state: batched == sequential
        live = (~st.done) & (st.it < self.max_iters)
        return _State(*(_where_rows(live, u, o) for u, o in zip(new, st)))

    def _run(self, env: Env, st: _State, steps: Optional[int] = None):
        """Iterate until every element is done or out of iterations (or
        for at most ``steps`` iterations)."""
        k = 0
        while steps is None or k < steps:
            live = (~st.done) & (st.it < self.max_iters)
            self.host_syncs += 1
            if not bool(live.any()):
                break
            st = self._body(env, st)
            k += 1
        return st

    def _init(self, T0: torch.Tensor) -> _State:
        sub = self.substrate
        B, I, D = T0.shape[0], self.max_iters, sub.n_domains
        dev = T0.device
        zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        return _State(
            T=T0.to(torch.float32),
            it=torch.zeros((B,), dtype=torch.int32, device=dev),
            idx=torch.full((B, D), sub.nominal_idx, dtype=torch.long,
                           device=dev),
            f_sel=zf(B, D), p_sel=zf(B, D), obj_sel=zf(B, D),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            idx_hist=torch.zeros((B, I, D), dtype=torch.long, device=dev),
            p_hist=zf(B, I), tj_hist=zf(B, I))

    def _finalize(self, env: Env, st: _State) -> Solution:
        # re-evaluate the final choice at the converged temperature field
        # (the legacy flows report baseline power / Algorithm-2 delay there)
        sub = self.substrate
        d_fin = sub.delay_at(st.T, st.idx, env)
        f_fin = self.policy.frequency(sub, d_fin, _policy_env(env, 2))
        p_fin = sub.power_at(st.T, st.idx, f_fin, env)
        out = Solution(
            idx=st.idx, f=st.f_sel, power=st.p_sel, obj=st.obj_sel, T=st.T,
            n_iters=st.it, converged=st.done,
            d_final=d_fin, f_final=f_fin, p_final=p_fin,
            idx_hist=st.idx_hist, p_hist=st.p_hist, tj_hist=st.tj_hist)
        return Solution(*(x.cpu().numpy() for x in out))

    # ------------------------------------------------------------------
    def _env_tensors(self, env: Dict[str, Any], batched: bool) -> Env:
        dev = self.substrate.device
        out = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
               for k, v in env.items()}
        if not batched:
            return {k: v.reshape(1) for k, v in out.items()}
        B = int(next(iter(out.values())).shape[0])
        for k, v in out.items():
            if v.shape[:1] != (B,):
                raise ValueError(
                    f"env leaf {k!r} must lead with the batch axis {B}, "
                    f"got shape {tuple(v.shape)}")
        return out

    def _T0(self, env: Env, T0) -> torch.Tensor:
        if T0 is None:
            return self.substrate.T0(env)
        T0 = torch.as_tensor(np.asarray(T0, np.float32),
                             device=self.substrate.device)
        return T0.reshape(-1, T0.shape[-1]).expand(
            next(iter(env.values())).shape[0], -1).clone()

    def solve(self, env: Dict[str, Any], T0=None) -> Solution:
        """Run the fixed point for one environment."""
        env_t = self._env_tensors(env, batched=False)
        st = self._run(env_t, self._init(self._T0(env_t, T0)))
        return Solution(*(x[0] for x in self._finalize(env_t, st)))

    def solve_batch(self, envs: Dict[str, Any], T0=None, *,
                    early_freeze: bool = False,
                    segment: int = 2) -> Solution:
        """The fixed point over the leading axis of every env leaf, in one
        batched loop (the dynamic scheme's LUT build, the gamma sweep).

        ``early_freeze=True`` runs segments of ``segment`` iterations and
        compacts converged elements out of the batch between segments.
        """
        env_t = self._env_tensors(envs, batched=True)
        st = self._init(self._T0(env_t, T0))
        if early_freeze:
            st = self._run_freeze(env_t, st, max(int(segment), 1))
        else:
            st = self._run(env_t, st)
        return self._finalize(env_t, st)

    def _run_freeze(self, env: Env, st: _State, seg: int) -> _State:
        B = st.T.shape[0]
        dev = st.T.device
        active = np.arange(B)
        while active.size:
            # pad the active set to the next power-of-two bucket, capped at
            # the batch; padding repeats the first active element and its
            # duplicate rows are discarded
            P = min(1 << (int(active.size) - 1).bit_length(), B)
            pad = torch.as_tensor(np.concatenate(
                [active, np.repeat(active[:1], P - active.size)]),
                device=dev)
            sub_env = {k: v[pad] for k, v in env.items()}
            out = self._run(sub_env, _State(*(x[pad] for x in st)), seg)
            n = int(active.size)
            rows = pad[:n]
            st = _State(*(cur.index_copy(0, rows, new[:n])
                          for cur, new in zip(st, out)))
            done = st.done[rows].cpu().numpy()
            it = st.it[rows].cpu().numpy()
            self.host_syncs += 1
            active = active[(~done) & (it < self.max_iters)]
        return st


# =============================================================================
# solver cache — repeated wrapper calls reuse solvers (and their STA)
# =============================================================================

_CACHE_LIMIT = 32
_SOLVER_CACHE: "OrderedDict" = OrderedDict()


def cached_solver(substrate: Substrate, policy: Policy,
                  delta_t: float = 0.1, max_iters: int = 10,
                  refine_window: Optional[float] = None) -> Solver:
    """Memoize Solver instances by configuration. Substrates compare by
    identity (pair with the memoized ``fpga_substrate``); policies are
    frozen dataclasses and compare by value."""
    key = (id(substrate), policy, float(delta_t), int(max_iters),
           refine_window)
    if key in _SOLVER_CACHE:
        _SOLVER_CACHE.move_to_end(key)
        return _SOLVER_CACHE[key]
    solver = _SOLVER_CACHE[key] = Solver(substrate, policy, delta_t,
                                         max_iters, refine_window)
    if len(_SOLVER_CACHE) > _CACHE_LIMIT:
        _SOLVER_CACHE.popitem(last=False)
    return solver
