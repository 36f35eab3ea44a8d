#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``), the CUDA
   version, and TF32 switched off for float32 products (TF32 in the
   prolongation or the coarse inverse moves T by ~1e-3 relative, enough to
   flip a feasibility decision);
2. build: ``nvcc`` compiles both kernel sources from the repository (one
   process each, started together) and ``-Xptxas -v`` reports registers,
   shared memory and spills;
3. stencil vs plain: every grid the main path gives the thermal-stencil
   kernel and both launch shapes (resident and global), both sweep kinds and
   batch sizes 1 and 86, compared with the plain PyTorch version on the same
   inputs on the card (tolerance 0: bit for bit), and timed with CUDA events
   at the main path's shapes beside the bound (bytes over the memory rate or
   float operations over the float32 rate, whichever is larger);
4. main path (Algorithm 1) at full size through the entry points a user
   calls: Table II on mkDelayWorker32B and mcml (152x152), the 86-ambient
   dynamic LUT as one batched solve, and Algorithm 2 on mkPktMerge; each is
   held against the port on the CPU and against the reference values, and
   the stencil kernel must have been launched;
5. over-scaling path (§III-D, Fig 8): ``overscaling.sweep`` of the LeNet and
   HD netlists over six budgets (one batched solve each) on the card, held
   against the CPU port and the reference decisions, GOLDEN_OS; LeNet
   trained on the card (500 steps), then its int8 inference at n = 1024
   through the error-injecting kernel for every budget, its logits equal bit
   for bit to the plain path's; HD's accuracies beside them;
6. §V path: ``AbftMatmul`` at llama3.2-1b's MLP widths (2048 -> 8192 ->
   2048) for 48 and 4096 tokens at eight rails at 65 C, its ledgers through
   the kernel equal to those through the plain version, and the guard-band
   rails injecting nothing;
7. int8 kernels vs plain: both error-injecting kernels on every shape of
   paths 5 and 6 and five bit profiles, plus a product whose accumulators
   and checksums wrap (tolerance 0: int32 equality), timed beside the bound
   and, where it accepts the shape, ``torch._int_mm`` (the product alone);
8. profile: one warm Table II run and one warm LeNet inference at gamma =
   1.35 under ``torch.profiler``: device time by kernel and the card's idle
   share of the wall time.

Each path runs with every launch count set to 0 just before it and read
just after. The last lines are the kernel table as one JSON object, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
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
INT8_OP_PER_S = 1979e12  # int8 tensor cores, dense
# float operations per cell and sweep: 3 adds of neighbours, P + g_v_tamb,
# one product, one add, one division
STENCIL_FLOPS_PER_CELL = 7
# reference decisions (the JAX package on the CPU)
TABLE_II = {"iters": 4, "v_core": 0.75, "v_bram": 0.83, "power_mw": 554.60}
MCML = {"iters": 3, "v_core": 0.75, "v_bram": 0.70, "power_mw": 1753.45}
GOLDEN_EO = {"v_core": 0.55, "v_bram": 0.55, "d_opt_ns": 17.019848,
             "energy": 27.992240, "saving": 0.640888,
             "freq_ratio": 0.367218}  # energy_opt.run(mkPktMerge, 65C, theta 2)
# (m, n, B) of the smoother's calls on the main path and on the
# over-scaling path (the LeNet and HD netlists, 56x56 and 69x69, and their
# coarse levels; B = 6 budgets in the sweep, 1 in the baseline)
MAIN_PATH_SHAPES = [(92, 92, 1), (46, 46, 1), (23, 23, 1), (152, 152, 1),
                    (76, 76, 1), (38, 38, 1), (92, 92, 86), (46, 46, 86),
                    (23, 23, 86), (56, 56, 6), (28, 28, 6), (69, 69, 6),
                    (35, 35, 6), (56, 56, 1), (69, 69, 1)]
# --- the over-scaling path (§III-D, Fig 8) ---------------------------------
GAMMAS = [1.0, 1.1, 1.2, 1.3, 1.35, 1.4]
# reference decisions, overscaling.sweep at 40 C, theta_JA 12 (the JAX
# package on the CPU): gamma -> (v_core, v_bram, power mW, frac_violating)
FIG8 = {
    "lenet": {1.0: (0.73, 0.71, 419.3254, 0.0),
              1.2: (0.66, 0.70, 316.2118, 0.5664),
              1.35: (0.63, 0.55, 275.0631, 0.8438)},
    "hd": {1.0: (0.72, 0.70, 456.4909, 0.0),
           1.2: (0.65, 0.70, 335.3452, 0.6289),
           1.35: (0.63, 0.55, 303.9151, 0.8633)},
}
GOLDEN_OS = {"v_core": 0.66, "v_bram": 0.70, "power_mw": 39.173454,
             "frac_violating": 0.542969}  # overscaling.run(raygentop, 1.2)
APP_SEED = 42
LENET_STEPS = 500  # examples/overscaling_study.py without --quick
LENET_N = 1024  # lenet_accuracy's evaluation set
# --- the §V path: llama3.2-1b's MLP widths (configs/llama3_2_1b.py) --------
D_MODEL, D_FF = 2048, 8192
TOKENS = [48, 4096]  # 2 x 24 tokens (the study), and a 4096-token batch
SEC5_T = 65.0  # chip temperature of the study's rail sweep
DEV = "cuda"
# (M, K, N) of the error-injecting kernels' calls on the two paths
LENET_MM = [(262144, 9, 8), (65536, 72, 16), (1024, 256, 10)]
LLAMA_MM = [(M, k, n) for M in TOKENS
            for k, n in ((D_MODEL, D_FF), (D_FF, D_MODEL))]
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


KERNEL_SOURCES = ("thermal_stencil", "int8_error_matmul")


def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.time()
    _build.build_all(KERNEL_SOURCES)
    print(f"build: {', '.join(KERNEL_SOURCES)} in {time.time() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def _wrappers():
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import overscale_matmul as OM
    from repro_torch.kernels import thermal_stencil as TS
    return {"thermal_stencil": TS.thermal_stencil,
            "overscale_matmul": OM.overscale_matmul,
            "abft_matmul": AB.abft_matmul}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


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


def _events_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _time_ms(torch, fn, reps: int = 0) -> float:
    """Mean time of one call over ``reps`` back-to-back calls after warm-up,
    with CUDA events; ``reps=0`` picks enough calls for ~100 ms (3 to 200)."""
    for _ in range(5 if reps else 2):
        fn()
    torch.cuda.synchronize()
    if not reps:
        one = max(_events_ms(torch, fn, 1), 1e-3)
        reps = int(min(max(100.0 / one, 3), 200))
    return _events_ms(torch, fn, reps)


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
    reset_counts()
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
    counts = read_counts()
    launches = counts["thermal_stencil"]
    print(f"main path: launches {counts}")
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


def _same_decision(got, want_vc, want_vb, want_mw, want_frac) -> bool:
    return (abs(got.v_core - want_vc) < 1e-3
            and abs(got.v_bram - want_vb) < 1e-3
            and abs(got.power_mw / want_mw - 1.0) <= 1e-3
            and abs(got.frac_violating - want_frac) <= 1 / 256)


def overscaling_path(torch) -> dict:
    """§III-D at full size through the entry points: the Fig-8 sweep of the
    LeNet and HD netlists (one batched solve each), GOLDEN_OS, LeNet trained
    on the card and run through the error-injecting int8 kernel for every
    budget, HD beside it. Counts are read just after; the checks against
    the plain path, the CPU port and the reference values follow."""
    from repro_torch.core import apps
    from repro_torch.core import netlist as NL
    from repro_torch.core import overscaling as OS
    from repro_torch.core import thermal
    from repro_torch.core import vtr_benchmarks as vb

    tc = thermal.ThermalConfig(theta_ja=12.0)
    nets = {"lenet": NL.generate(apps.LENET_STATS),
            "hd": NL.generate(apps.HD_STATS)}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps = {k: OS.sweep(nl, GAMMAS, t_amb=40.0, tc=tc, device=DEV)
              for k, nl in nets.items()}
    golden = OS.run(vb.load("raygentop"), 1.2, t_amb=40.0, tc=tc,
                    device=DEV)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    p, info = apps.lenet_train(APP_SEED, steps=LENET_STEPS, device=DEV)
    hd = apps.hd_train(APP_SEED, device=DEV)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0 - t_sweep
    acc_float = apps.lenet_accuracy(p, APP_SEED, n=LENET_N, device=DEV)
    acc_int8 = apps.lenet_accuracy(p, APP_SEED, n=LENET_N,
                                   bit_probs=np.zeros(32), device=DEV)
    hd_clean = apps.hd_accuracy(hd, APP_SEED, device=DEV)
    rows, logits = [], {}
    for r_l, r_h in zip(sweeps["lenet"], sweeps["hd"]):
        probs = apps.scale_bit_probs(r_l.bit_probs)
        lg, y = apps.lenet_logits(p, APP_SEED, LENET_N, probs,
                                  device=DEV)
        logits[r_l.gamma] = lg
        rows.append({
            "gamma": r_l.gamma,
            "lenet": (r_l.v_core, r_l.v_bram, r_l.power_mw, r_l.saving,
                      r_l.frac_violating),
            "lenet_acc": float((lg.argmax(-1) == y).float().mean()),
            "hd": (r_h.v_core, r_h.v_bram, r_h.power_mw, r_h.saving,
                   r_h.frac_violating),
            "hd_acc": apps.hd_accuracy(
                hd, APP_SEED, flip_prob=apps.hd_flip_prob(r_h.bit_probs),
                device=DEV)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"over-scaling path: wall {wall:.3f} s (sweeps + GOLDEN_OS "
          f"{t_sweep:.3f} s, LeNet {LENET_STEPS} steps + HD training "
          f"{t_train:.3f} s); launches {counts}; LeNet final loss "
          f"{info['final_loss']:.4f}")
    check(counts["thermal_stencil"] > 0 and counts["overscale_matmul"] > 0,
          "the over-scaling path launched the stencil and the int8 kernel")

    # the plain path on the same seeds gives the same logits, bit for bit
    for r_l in sweeps["lenet"]:
        lg_p, _ = apps.lenet_logits(
            p, APP_SEED, LENET_N, apps.scale_bit_probs(r_l.bit_probs),
            use_kernel=False, device=DEV)
        check(torch.equal(lg_p, logits[r_l.gamma]),
              f"LeNet logits at gamma {r_l.gamma}: kernel == plain")
    check(rows[0]["gamma"] == 1.0 and rows[0]["lenet"][4] == 0.0
          and rows[0]["lenet_acc"] == acc_int8,
          "gamma 1.0 violates nothing: accuracy == clean int8 accuracy")
    # the same sweeps on the CPU port, and the reference's decisions
    t0 = time.perf_counter()
    for k, nl in nets.items():
        cpu = OS.sweep(nl, GAMMAS, t_amb=40.0, tc=tc, device="cpu")
        for g, c in zip(sweeps[k], cpu):
            check(_same_decision(g, c.v_core, c.v_bram, c.power_mw,
                                 c.frac_violating)
                  and abs(g.saving - c.saving) < 1e-3,
                  f"{k} gamma {g.gamma}: card == cpu port")
        for g in sweeps[k]:
            if g.gamma in FIG8[k]:
                check(_same_decision(g, *FIG8[k][g.gamma]),
                      f"{k} gamma {g.gamma}: == reference {FIG8[k][g.gamma]}")
    print(f"cpu port: both sweeps in {time.perf_counter() - t0:.1f} s")
    check(_same_decision(golden, GOLDEN_OS["v_core"], GOLDEN_OS["v_bram"],
                         GOLDEN_OS["power_mw"], GOLDEN_OS["frac_violating"]),
          f"GOLDEN_OS ({golden.v_core}, {golden.v_bram}, {golden.power_mw})")

    print(f"Fig 8 (40 C, theta_JA 12): clean LeNet float {acc_float:.4f}, "
          f"int8 {acc_int8:.4f}; HD {hd_clean:.4f}")
    print(f"{'app':6s} {'gamma':6s} {'V_core':7s} {'V_bram':7s} "
          f"{'power_mW':10s} {'saving':8s} {'frac_viol':10s} accuracy")
    for r in rows:
        for app in ("lenet", "hd"):
            vc, vbr, mw, sav, frac = r[app]
            print(f"{app:6s} {r['gamma']:<6.2f} {vc:<7.2f} {vbr:<7.2f} "
                  f"{mw:<10.4f} {sav:<8.4f} {frac:<10.4f} "
                  f"{r[app + '_acc']:.4f}")
    fig8 = apps.scale_bit_probs(
        next(r for r in sweeps["lenet"] if r.gamma == 1.35).bit_probs)
    return {"counts": counts, "wall_s": wall, "fig8_probs": fig8,
            "params": p, "rows": rows}


def sec5_path(torch) -> dict:
    """§V at llama3.2-1b's MLP widths: AbftMatmul on the up and down
    products for 48 and 4096 tokens at each rail of the study (nominal, then
    0.730 V down to 0.700 V) at 65 C, through the kernel (counted), then
    through the plain version on the same seeds."""
    from repro_torch.core import tpu_fleet as TF
    from repro_torch.tolerance import AbftMatmul, TimingFaultModel

    fm = TimingFaultModel()
    rails = [TF.V_CORE_NOM] + [round(0.730 - 0.005 * i, 3) for i in range(7)]
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    x = {M: randn(M, D_MODEL) for M in TOKENS}
    h = {M: randn(M, D_FF) for M in TOKENS}
    # the model's init scale: normal / sqrt(fan_in) (models/params.py)
    w_up = randn(D_MODEL, D_FF) / D_MODEL ** 0.5
    w_down = randn(D_FF, D_MODEL) / D_FF ** 0.5

    def run(use_kernel: bool):
        ledgers, outs = [], []
        for vc in rails:
            mm = AbftMatmul(fm.bit_probs(vc, TF.V_SRAM_NOM, SEC5_T), 9,
                            use_kernel=use_kernel, device=DEV)
            for M in TOKENS:
                outs += [mm(x[M], w_up), mm(h[M], w_down)]
            ledgers.append(mm.counters)
        return ledgers, outs

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    led_k, out_k = run(True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"§V path: wall {wall:.3f} s; launches {counts}")
    check(counts["abft_matmul"] > 0, "the §V path launched the ABFT kernel")
    led_p, out_p = run(False)
    check(led_k == led_p, "§V ledgers: kernel == plain")
    check(all(torch.equal(a, b) for a, b in zip(out_k, out_p)),
          "§V outputs: kernel == plain")
    print(f"{'v_core':7s} {'overshoot':10s} {'checked':>9s} {'inj':>8s} "
          f"{'det':>8s} {'corr':>8s} {'esc':>8s}")
    guard = 0
    for vc, c in zip(rails, led_k):
        x_over = float(fm.overshoot(vc, TF.V_SRAM_NOM, SEC5_T))
        print(f"{vc:<7.3f} {x_over:<10.4f} {c.checked:>9d} {c.injected:>8d} "
              f"{c.detected:>8d} {c.corrected:>8d} {c.escaped:>8d}")
        if x_over == 0.0:
            guard += 1
            check(c.injected == 0 and c.escaped == 0,
                  f"guard-band rail {vc} injects nothing")
    check(guard >= 1 and led_k[-1].injected > 0,
          "the sweep spans the guard band and rails below it")
    return {"counts": counts, "wall_s": wall,
            "ledgers": [(vc, vars(c)) for vc, c in zip(rails, led_k)]}


def _mm_bound(M, K, N, sums: bool):
    """(ms, "bytes" | "operations"): a and b read once, both planes read, c
    written (and the two checksums), against 2*M*N*K int8 operations."""
    nbytes = M * K + K * N + 4 * 2 * M * N + 4 * M * N + 33 * 4
    nbytes += 4 * (M + N) if sums else 0
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * N * K / INT8_OP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int8_kernel_phase(torch, fig8_probs) -> dict:
    """Both error-injecting kernels against their plain versions on every
    (M, K, N) of the two paths and five bit profiles (tolerance 0), a
    product whose accumulators and checksums wrap, then times."""
    from repro_torch.core import tpu_fleet as TF
    from repro_torch.kernels import abft_matmul as AB
    from repro_torch.kernels import overscale_matmul as OM
    from repro_torch.tolerance import TimingFaultModel

    tail24 = np.zeros(32)
    tail24[24:] = 0.02
    profiles = {
        "zero": np.zeros(32), "fig8_lenet_g1.35": fig8_probs,
        "tail24_0.02": tail24, "bit30_0.05": np.eye(32)[30] * 0.05,
        "fault_0.70V_65C": TimingFaultModel().bit_probs(0.70, TF.V_SRAM_NOM,
                                                        65.0)}
    g = torch.Generator(device=DEV)
    g.manual_seed(17)
    worst = {"overscale_matmul": 0, "abft_matmul": 0}

    def diff(x, y):
        return int((x.long() - y.long()).abs().max()) if x.numel() else 0

    inputs = {}
    for (M, K, N) in LENET_MM + LLAMA_MM:
        a = torch.randint(-128, 128, (M, K), dtype=torch.int8, generator=g,
                          device=DEV)
        b = torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=g,
                          device=DEV)
        ug, ub = OM.random_planes(g, (M, N), DEV)
        inputs[(M, K, N)] = (a, b, ug, ub)
        for name, probs in profiles.items():
            cdf = OM.bit_probs_to_cdf(probs, DEV)
            c, clean = OM.overscale_matmul(a, b, ug, ub, cdf,
                                           return_clean=True)
            c_r, clean_r = OM.overscale_matmul_ref(a, b, ug, ub, cdf,
                                                   return_clean=True)
            abft = AB.abft_matmul(a, b, ug, ub, cdf)
            abft_r = AB.abft_matmul_ref(a, b, ug, ub, cdf)
            torch.cuda.synchronize()
            e_o = max(diff(c, c_r), diff(clean, clean_r))
            e_a = max(diff(x, y) for x, y in zip(abft, abft_r))
            worst["overscale_matmul"] = max(worst["overscale_matmul"], e_o)
            worst["abft_matmul"] = max(worst["abft_matmul"], e_a)
            wraps = bool((c.long().sum(1) != abft[1].long()).any())
            print(f"int8 {M}x{K}x{N} {name}: flipped "
                  f"{int((c != clean).sum())}, checksums wrap {wraps}, "
                  f"max|kernel-plain| overscale {e_o} abft {e_a}")
    # K = 2^17 products of (-128)(-128): each accumulator is 2^31 and wraps
    # to -2^31, and so does every checksum
    M, K, N = 8, 1 << 17, 8
    a = torch.full((M, K), -128, dtype=torch.int8, device=DEV)
    b = torch.full((K, N), -128, dtype=torch.int8, device=DEV)
    ug, ub = OM.random_planes(g, (M, N), DEV)
    cdf = OM.bit_probs_to_cdf(profiles["fault_0.70V_65C"], DEV)
    abft = AB.abft_matmul(a, b, ug, ub, cdf)
    abft_r = AB.abft_matmul_ref(a, b, ug, ub, cdf)
    e = max(diff(x, y) for x, y in zip(abft, abft_r))
    worst["abft_matmul"] = max(worst["abft_matmul"], e)
    print(f"int8 wrap case {M}x{K}x{N}: c[0,0] {int(abft_r[0][0, 0])}, "
          f"rowsum[0] {int(abft_r[1][0])}, max|kernel-plain| {e}")
    check(bool((abft_r[0] == -2 ** 31).any()), "the wrap case wraps")
    check(worst == {"overscale_matmul": 0, "abft_matmul": 0},
          f"int8 kernels equal their plain versions bit for bit ({worst})")

    rows = {"overscale_matmul": [], "abft_matmul": []}
    cdf = OM.bit_probs_to_cdf(tail24, DEV)
    for (M, K, N), (a, b, ug, ub) in inputs.items():
        lib_ok = M > 16 and K % 8 == 0 and N % 8 == 0
        lib_ms = (_time_ms(torch, lambda: torch._int_mm(a, b)) if lib_ok
                  else None)
        for name, kern, plain, sums in (
                ("overscale_matmul", OM.overscale_matmul,
                 OM.overscale_matmul_ref, False),
                ("abft_matmul", AB.abft_matmul, AB.abft_matmul_ref, True)):
            k_ms = _time_ms(torch, lambda: kern(a, b, ug, ub, cdf))
            p_ms = _time_ms(torch, lambda: plain(a, b, ug, ub, cdf))
            bound, by = _mm_bound(M, K, N, sums)
            rows[name].append({"M": M, "K": K, "N": N, "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": bound,
                               "bound_by": by, "library_ms": lib_ms})
            print(f"time {name} {M}x{K}x{N}: kernel {k_ms:.5f} ms, plain "
                  f"{p_ms:.5f} ms, bound {bound:.7f} ms ({by}), "
                  f"torch._int_mm (product only) "
                  + (f"{lib_ms:.5f} ms" if lib_ok else
                     "refuses the shape (needs M > 16, K and N % 8 == 0)"))
    return {"max_abs_err": worst, "rows": rows}


def _profile(torch, label: str, run) -> None:
    """Device time by kernel (the torch profiler) and the card's idle share
    of the wall time of one warm ``run()``."""
    from torch.profiler import ProfilerActivity, profile
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
    print(f"profile {label} (warm): wall {wall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e6 / wall:.4f}")
    for e in sorted(events, key=dev, reverse=True)[:12]:
        print(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def profile_phase(torch, table2_launches: int, lenet_params, fig8_probs):
    """Where the time goes in one warm Table II run and one warm LeNet
    inference at gamma = 1.35 (n = 1024). Runs after the paths' counts were
    read; the Table II warm-up repeats the main path's run, and its launch
    count is printed beside that one's."""
    from repro_torch.core import apps
    from repro_torch.core import thermal
    from repro_torch.core import voltage_scaling as VS
    from repro_torch.core import vtr_benchmarks as vb
    from repro_torch.kernels import thermal_stencil as TS
    table2 = lambda: VS.run(vb.load("mkDelayWorker32B"), 60.0, 1.0,
                            thermal.ThermalConfig(theta_ja=12.0),
                            device="cuda")
    l0 = TS.thermal_stencil.launches
    table2()  # warm: the substrate and its STA are cached
    torch.cuda.synchronize()
    print(f"repeat table2: stencil launches {TS.thermal_stencil.launches - l0}"
          f" (main path's run: {table2_launches})")
    _profile(torch, "table2", table2)
    lenet = lambda: apps.lenet_accuracy(lenet_params, APP_SEED, n=LENET_N,
                                        bit_probs=fig8_probs, device="cuda")
    lenet()
    _profile(torch, "lenet gamma=1.35 n=1024", lenet)


def _kernel_entry(name, source, replaces, launches, err, rep, shapes):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shapes": shapes}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    resolve_device(None)
    t_start = time.perf_counter()
    card = device_phase(torch)
    build_phase()
    k = kernel_phase(torch)
    mp = main_path_phase(torch)
    osp = overscaling_path(torch)
    sec5 = sec5_path(torch)
    mm = int8_kernel_phase(torch, osp["fig8_probs"])
    profile_phase(torch,
                  mp["runs"]["table2_mkDelayWorker32B"]["stencil_launches"],
                  osp["params"], osp["fig8_probs"])
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    src = "src/repro_torch/kernels/csrc/"
    rep_stencil = dict(k["rows"][0], library_ms=None)  # 92x92, B = 1
    # the representative rows: LeNet's conv2 product (65536x72x16, which
    # torch._int_mm accepts) and llama's up product at 4096 tokens
    rep_os = mm["rows"]["overscale_matmul"][1]
    rep_abft = next(r for r in mm["rows"]["abft_matmul"]
                    if (r["M"], r["K"], r["N"]) == (4096, D_MODEL, D_FF))
    print(json.dumps({"kernels": [
        _kernel_entry("thermal_stencil", src + "thermal_stencil.cu",
                      "src/repro/kernels/thermal_stencil.py:82",
                      mp["launches"], k["max_abs_err"], rep_stencil,
                      k["rows"]),
        _kernel_entry("overscale_matmul", src + "int8_error_matmul.cu",
                      "src/repro/kernels/overscale_matmul.py:78",
                      osp["counts"]["overscale_matmul"],
                      mm["max_abs_err"]["overscale_matmul"], rep_os,
                      mm["rows"]["overscale_matmul"]),
        _kernel_entry("abft_matmul", src + "int8_error_matmul.cu",
                      "src/repro/kernels/abft_matmul.py:98",
                      sec5["counts"]["abft_matmul"],
                      mm["max_abs_err"]["abft_matmul"], rep_abft,
                      mm["rows"]["abft_matmul"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
