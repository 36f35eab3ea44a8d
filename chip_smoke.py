#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA
   version, and TF32 switched off for float32 products (TF32 in the
   prolongation or the coarse inverse moves T by ~1e-3 relative, enough to
   flip a feasibility decision);
2. build: ``nvcc`` compiles the thermal-stencil kernel from the repository's
   sources and ``-Xptxas -v`` reports registers, shared memory and spills;
3. kernel vs plain: every grid the main path gives the kernel and both
   launch shapes (resident and global), both sweep kinds and batch sizes 1
   and 86, compared with the plain PyTorch version on the same inputs on
   the card (tolerance 0: bit for bit), and timed with CUDA events at the
   main path's shapes beside the bound (bytes over the memory rate or float
   operations over the float32 rate, whichever is larger);
4. main path at full size through the entry points a user calls: Algorithm 1
   on mkDelayWorker32B (the paper's Table II case) and on mcml (152x152),
   the 86-ambient dynamic LUT as one batched solve, and Algorithm 2 on
   mkPktMerge; each is held against the port on the CPU and against the
   reference values, and the stencil kernel must have been launched;
5. profile: one warm Table II run under ``torch.profiler``: device time by
   kernel and the card's idle share of the wall time.

The last lines are the kernel table as one JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published peaks (H100 SXM data sheet) for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
# float operations per cell and sweep: 3 adds of neighbours, P + g_v_tamb,
# one product, one add, one division
STENCIL_FLOPS_PER_CELL = 7
# reference decisions (the JAX package on the CPU)
TABLE_II = {"iters": 4, "v_core": 0.75, "v_bram": 0.83, "power_mw": 554.60}
MCML = {"iters": 3, "v_core": 0.75, "v_bram": 0.70, "power_mw": 1753.45}
GOLDEN_EO = {"v_core": 0.55, "v_bram": 0.55, "d_opt_ns": 17.019848,
             "energy": 27.992240, "saving": 0.640888,
             "freq_ratio": 0.367218}  # energy_opt.run(mkPktMerge, 65C, theta 2)
# (m, n, B) of the smoother's calls on the main path
MAIN_PATH_SHAPES = [(92, 92, 1), (46, 46, 1), (23, 23, 1), (152, 152, 1),
                    (76, 76, 1), (38, 38, 1), (92, 92, 86), (46, 46, 86),
                    (23, 23, 86)]
# shapes held bit for bit against the plain version at B = 1 and 86: every
# grid of the main path, plus the edges (1x1, odd, the global shape)
STENCIL_SHAPES = [(1, 1), (23, 17), (256, 256)] + sorted(
    {(m, n) for m, n, _ in MAIN_PATH_SHAPES})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_phase(torch) -> str:
    card = smi_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"tf32 before: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    return card


def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.build("thermal_stencil")
    print(f"build: thermal_stencil in {time.time() - t0:.1f} s")
    for line in _build.build_log("thermal_stencil").splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())


def _stencil_inputs(torch, m, n, B, seed=11):
    from repro_torch.core import thermal
    g_v, g_lat = thermal.conductances(m, n, thermal.ThermalConfig(theta_ja=12.0))
    rng = np.random.default_rng(seed)
    T = torch.tensor(rng.uniform(25, 40, (B, m, n)), dtype=torch.float32,
                     device="cuda")
    P = torch.tensor(rng.uniform(0, 5e-3, (B, m, n)), dtype=torch.float32,
                     device="cuda")
    diag = torch.tensor(thermal._diag_np(np.full((m, n), g_v), g_lat),
                        dtype=torch.float32, device="cuda")
    return T, P, diag, g_lat, g_v * 25.0


def _time_ms(torch, fn, reps: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stencil_bound(T, P, diag, iters: int):
    """(ms, "bytes" | "operations"): the least time for one call on these
    inputs. Each input is read once and T written once; an input shared
    across the batch (P or diag of shape (m, n)) is read once."""
    B, m, n = T.shape
    per_grid = lambda x: B if x.dim() == 3 and x.shape[0] == B else 1
    nbytes = 4 * m * n * (2 * B + per_grid(P) + per_grid(diag))
    flops = STENCIL_FLOPS_PER_CELL * m * n * B * iters
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch) -> dict:
    from repro_torch.kernels import thermal_stencil as TS
    worst = 0.0
    for (m, n) in STENCIL_SHAPES:
        for B in (1, 86):
            T, P, diag, g_lat, g_vt = _stencil_inputs(torch, m, n, B)
            for phase in (None, 0, 1):
                for iters in (1, 31):
                    kw = dict(g_lat=g_lat, g_v_tamb=g_vt, iters=iters,
                              phase=phase)
                    out = TS.thermal_stencil(T, P, diag, **kw)
                    ref = TS.thermal_stencil_ref(T, P, diag, g_lat, g_vt,
                                                 iters, phase)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    worst = max(worst, err)
                    shape = ("resident" if TS.is_resident(m, n, phase, T.device)
                             else "global")
                    print(f"stencil {m}x{n} B={B} phase={phase} iters={iters}"
                          f" {shape}: max|kernel-plain|={err:.3e}")
    # tolerance 0: the kernel rounds every operation as the plain version
    check(worst == 0.0, f"stencil kernel equals plain bit for bit "
                        f"(max {worst})")

    rows = []
    for (m, n, B) in MAIN_PATH_SHAPES:
        T, P, diag, g_lat, _ = _stencil_inputs(torch, m, n, B)
        kw = dict(g_lat=g_lat, g_v_tamb=0.0, iters=1, phase=0)
        k_ms = _time_ms(torch, lambda: TS.thermal_stencil(T, P, diag, **kw),
                        200)
        p_ms = _time_ms(torch, lambda: TS.thermal_stencil_ref(
            T, P, diag, g_lat, 0.0, 1, 0), 200)
        bound, by = stencil_bound(T, P, diag, 1)
        rows.append({"m": m, "n": n, "B": B, "iters": 1, "phase": 0,
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                     "bound_by": by})
        print(f"time {m}x{n} B={B} rb iters=1: kernel {k_ms:.5f} ms, plain "
              f"{p_ms:.5f} ms, bound {bound:.7f} ms ({by})")
    print("library: no single PyTorch call computes K fused stencil sweeps; "
          "library_ms is null")
    return {"max_abs_err": worst, "rows": rows}


def _trace(r):
    return [(t.v_core, t.v_bram, t.power_mw) for t in r.trace]


def _same_trace(a, b) -> bool:
    return (len(a) == len(b)
            and all(abs(x[0] - y[0]) < 1e-6 and abs(x[1] - y[1]) < 1e-6
                    and abs(x[2] / y[2] - 1.0) <= 1e-3 for x, y in zip(a, b)))


def _final_ok(r, ref) -> bool:
    return (len(r.trace) == ref["iters"]
            and abs(r.v_core - ref["v_core"]) < 1e-3
            and abs(r.v_bram - ref["v_bram"]) < 1e-3
            and abs(r.power_mw / ref["power_mw"] - 1.0) <= 1e-3)


def main_path_phase(torch) -> dict:
    from repro_torch import policy as pol
    from repro_torch.core import energy_opt as EO
    from repro_torch.core import thermal
    from repro_torch.core import voltage_scaling as VS
    from repro_torch.core import vtr_benchmarks as vb
    from repro_torch.kernels import thermal_stencil as TS

    TC12 = thermal.ThermalConfig(theta_ja=12.0)
    TC2 = thermal.ThermalConfig(theta_ja=2.0)
    mkdelay, mcml, mkpkt = (vb.load(n) for n in
                            ("mkDelayWorker32B", "mcml", "mkPktMerge"))
    t_ambs = [float(t) for t in range(86)]
    runs = {
        "table2_mkDelayWorker32B": lambda dev: VS.run(
            mkdelay, 60.0, 1.0, TC12, device=dev),
        "mcml_152x152": lambda dev: VS.run(mcml, 60.0, 1.0, TC2, device=dev),
        "dynamic_lut_86": lambda dev: VS.dynamic_lut(
            mkdelay, t_ambs, 1.0, TC12, device=dev),
        "energy_opt_mkPktMerge": lambda dev: EO.run(
            mkpkt, 65.0, 1.0, TC2, device=dev),
    }

    def solver_syncs():
        return sum(s.host_syncs for s in pol.solver._SOLVER_CACHE.values())

    # the counts are set to 0 just before the main path and read just after
    TS.thermal_stencil.launches = 0
    thermal.solve.calls = thermal.solve.host_syncs = 0
    stats, gpu = {}, {}
    for name, fn in runs.items():
        l0, c0 = TS.thermal_stencil.launches, thermal.solve.calls
        h0, f0 = thermal.solve.host_syncs, solver_syncs()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gpu[name] = fn("cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = thermal.solve.calls - c0
        stats[name] = {
            "wall_s": wall, "thermal_solves": calls,
            "stencil_launches": TS.thermal_stencil.launches - l0,
            "launches_per_solve": (TS.thermal_stencil.launches - l0)
            / max(calls, 1),
            "thermal_host_syncs_per_solve": (thermal.solve.host_syncs - h0)
            / max(calls, 1),
            "fixed_point_host_syncs": solver_syncs() - f0,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        }
        print(f"main path {name}: {json.dumps(stats[name])}")
    launches = TS.thermal_stencil.launches
    print(f"main path: thermal_stencil launches {launches}")
    check(launches > 0, "the main path launched the stencil kernel")

    # the same runs on the CPU port (plain stencil) as the yardstick
    t0 = time.perf_counter()
    cpu = {name: fn("cpu") for name, fn in runs.items()}
    print(f"cpu port: all four runs in {time.perf_counter() - t0:.1f} s")

    for name in ("table2_mkDelayWorker32B", "mcml_152x152"):
        g, c = gpu[name], cpu[name]
        print(f"{name} trace (v_core, v_bram, mW, Tj): "
              + str([(t.v_core, t.v_bram, round(t.power_mw, 4),
                      round(t.t_junct, 4)) for t in g.trace]))
        check(_same_trace(_trace(g), _trace(c)), f"{name}: card == cpu port")
    check(_final_ok(gpu["table2_mkDelayWorker32B"], TABLE_II),
          "Table II: 4 iterations -> (0.75, 0.83), 554.60 mW")
    check(_final_ok(gpu["mcml_152x152"], MCML),
          "mcml: 3 iterations -> (0.75, 0.70), 1753.45 mW")
    lut_g, lut_c = gpu["dynamic_lut_86"], cpu["dynamic_lut_86"]
    check(len(lut_g) == 86 and lut_g == lut_c, "86-ambient LUT: card == cpu")
    print(f"dynamic LUT (every 17 C): {list(lut_g.items())[::17]}")
    eo = gpu["energy_opt_mkPktMerge"]
    check(abs(eo.v_core - GOLDEN_EO["v_core"]) < 1e-3
          and abs(eo.v_bram - GOLDEN_EO["v_bram"]) < 1e-3
          and all(abs(getattr(eo, k) / GOLDEN_EO[k] - 1.0) <= 1e-3
                  for k in ("d_opt_ns", "energy", "freq_ratio"))
          and abs(eo.saving - GOLDEN_EO["saving"]) < 1e-3,
          f"energy_opt == GOLDEN_EO ({eo})")
    print(f"energy_opt mkPktMerge: ({eo.v_core}, {eo.v_bram}) d_opt "
          f"{eo.d_opt_ns:.6f} ns energy {eo.energy:.6f} saving "
          f"{eo.saving:.6f}")
    return {"launches": launches, "runs": stats}


def profile_phase(torch, table2_launches: int) -> None:
    """Where the time of one Table II run goes: device time by kernel (the
    torch profiler) and the device's idle share of the wall time. Runs after
    the main path's counts were read; the warm-up run repeats the main
    path's Table II run, and its launch count is printed beside that one's."""
    from repro_torch.kernels import thermal_stencil as TS
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import thermal
    from repro_torch.core import voltage_scaling as VS
    from repro_torch.core import vtr_benchmarks as vb
    run = lambda: VS.run(vb.load("mkDelayWorker32B"), 60.0, 1.0,
                         thermal.ThermalConfig(theta_ja=12.0), device="cuda")
    l0 = TS.thermal_stencil.launches
    run()  # warm: the substrate and its STA are cached
    torch.cuda.synchronize()
    print(f"repeat table2: stencil launches {TS.thermal_stencil.launches - l0}"
          f" (main path's run: {table2_launches})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) or 0)
    # the kernels themselves (device-side events); the aten ops that
    # launched them carry the same device time again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev(e) > 0]
    busy_us = sum(dev(e) for e in events)
    print(f"profile table2 (warm): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=dev, reverse=True)[:12]:
        print(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    resolve_device(None)
    card = device_phase(torch)
    build_phase()
    k = kernel_phase(torch)
    mp = main_path_phase(torch)
    profile_phase(torch,
                  mp["runs"]["table2_mkDelayWorker32B"]["stencil_launches"])
    rep = k["rows"][0]  # 92x92, B = 1: the Table II smoother call
    print(json.dumps({"kernels": [{
        "name": "thermal_stencil", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/thermal_stencil.cu",
        "replaces": "src/repro/kernels/thermal_stencil.py:82",
        "launches": mp["launches"], "max_abs_err": k["max_abs_err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": None,
        "at": "92x92 B=1 red-black iters=1", "shapes": k["rows"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
