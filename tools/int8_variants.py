#!/usr/bin/env python3
"""Where the error-injecting int8 kernel spends its time, on one CUDA card:
variants of ``csrc/int8_error_matmul.cu`` with one phase taken out, timed
beside the whole kernel.

    python3 tools/int8_variants.py

Each variant is a copy of the source with one piece of text replaced
(``CUTS``), built with the port's own ``nvcc`` flags under
``build/variants/`` and timed through the port's wrapper
(``overscale_matmul``, CUDA events over 20 back-to-back calls after warm-up)
at llama3.2-1b's 4096-row MLP products, with no flips (``zero``) and with
flips at a rate of 0.16 (``tail24``, bits 24..31 at 0.02 each):

- ``full``: the kernel as it is (its output is held to the plain version);
- ``epilogue``: the main loop skipped (the accumulators stay 0);
- ``main_loop``: the kernel returns before the epilogue.

The text replaced must match the source exactly: a change to the kernel
that moves it makes this tool stop with the variant's name. It prints one
JSON line per shape and profile, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

EPILOGUE = ("  // the epilogue streams whole rows: the accumulators go "
            "through shared")
LOOP = "  for (int i = 0; i < nk; ++i) {\n    cp_async_wait<S - 2>();"
CUTS = {
    "full": [],
    "epilogue": [(LOOP, "  for (int i = 0; i < 0; ++i) {\n"
                        "    cp_async_wait<S - 2>();")],
    # the kernel reads one accumulator, so the main loop is not dropped
    "main_loop": [(EPILOGUE, "  if (acc[0][0][0] == 12345) c[0] = 1;\n"
                             "  return;\n" + EPILOGUE)],
}
SHAPES = [(4096, 2048, 8192), (4096, 8192, 2048)]


def build_all(source: str, out: Path) -> dict:
    """Every variant's library, one ``nvcc`` each, all started together."""
    from repro_torch.kernels import _build
    jobs = {}
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"variant {name}: its text is not in the "
                                 f"source")
            text = text.replace(old, new)
        src, lib = out / f"{name}.cu", out / f"{name}.so"
        src.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{log}")
    return {name: lib for name, (lib, _) in jobs.items()}


def load(lib: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    tail = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    dll.overscale_matmul_launch.argtypes = [ctypes.c_void_p] * 9 + tail
    dll.overscale_matmul_launch.restype = ctypes.c_int
    return dll


def events_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
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


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import overscale_matmul as OM
    if not torch.cuda.is_available():
        print("int8_variants: no CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "int8_error_matmul.cu").read_text()
    libs = {name: load(lib) for name, lib in build_all(source, out).items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = OM._lib
    try:
        bench(torch, np, OM, libs, card)
    finally:
        OM._lib = lib  # the port's own library again
    return 0


def bench(torch, np, OM, libs: dict, card: str) -> None:
    """One JSON line per shape and profile: each variant's time (through
    the port's wrapper, its library swapped in) and ``torch._int_mm``'s."""
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    tail24 = np.zeros(32)
    tail24[24:] = 0.02
    for M, K, N in SHAPES:
        a = torch.randint(-128, 128, (M, K), dtype=torch.int8, generator=g,
                          device="cuda")
        b = torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=g,
                          device="cuda")
        ug, ub = OM.random_planes(g, (M, N), "cuda")
        for profile, probs in (("zero", np.zeros(32)), ("tail24", tail24)):
            cdf = OM.bit_probs_to_cdf(probs, "cuda")
            call = lambda: OM.overscale_matmul(a, b, ug, ub, cdf)
            row = {"M": M, "K": K, "N": N, "profile": profile, "card": card}
            for name, dll in libs.items():
                OM._lib = lambda dll=dll: dll
                row[f"{name}_ms"] = events_ms(torch, call)
                if name == "full":
                    row["full_equals_plain"] = torch.equal(
                        call(), OM.overscale_matmul_ref(a, b, ug, ub, cdf))
            row["int_mm_ms"] = events_ms(torch, lambda: torch._int_mm(a, b))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
