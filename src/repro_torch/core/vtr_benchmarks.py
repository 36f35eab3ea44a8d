"""The 10 industrial VTR benchmarks used by the paper (statistics).

A copy of ``repro.core.vtr_benchmarks``: the same published statistics,
generated by the port's own (numpy-seeded) ``netlist.generate``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.netlist import BenchStats, Netlist, generate

BENCHES: List[BenchStats] = [
    BenchStats("bgm", 32384, 0, 11, 65.0, "logic"),
    BenchStats("blob_merge", 6019, 0, 0, 90.0, "routing"),
    BenchStats("boundtop", 2921, 1, 0, 120.0, "mixed"),
    BenchStats("LU8PEEng", 21954, 45, 8, 55.0, "logic", bram_path_ratio=1 / 21),
    BenchStats("mcml", 106069, 38, 27, 50.0, "logic"),
    BenchStats("mkDelayWorker32B", 6128, 164, 0, 71.6, "memory",
               grid=(92, 92), bram_path_ratio=0.96),
    BenchStats("mkPktMerge", 231, 15, 0, 160.0, "memory", bram_path_ratio=0.90),
    BenchStats("or1200", 2963, 2, 1, 95.0, "routing"),
    BenchStats("raygentop", 1884, 1, 18, 110.0, "mixed"),
    BenchStats("stereovision0", 11462, 0, 0, 100.0, "routing"),
]

BY_NAME: Dict[str, BenchStats] = {b.name: b for b in BENCHES}

_cache: Dict[str, Netlist] = {}


def load(name: str, seed: int = 0) -> Netlist:
    key = f"{name}:{seed}"
    if key not in _cache:
        _cache[key] = generate(BY_NAME[name], seed)
    return _cache[key]

