#!/usr/bin/env python3
"""Time the Mamba2 SSD-scan kernel of several versions of the port on one
CUDA card, in turns.

    python3 tools/scan_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout whose ``src/repro_torch`` is the
package under test; the timing is this checkout's ``chip_smoke.scan_timing``
(every timed case of ``chip_smoke.py`` phase 9, float32 and bfloat16: CUDA
events over back-to-back calls after warm-up, and 20 calls in one CUDA graph
for the card alone), so every version is measured by the same code. Each runs in a process of its own, in the order given,
which compares two versions on one card and one host (parent, change,
change, parent). It prints one JSON line per run with the card's name and
power limit.

    python3 tools/scan_ab.py --summary RUNS.jsonl

reads those lines back and prints, for each case and each of the two times,
each tree's median and the count of pairs (consecutive runs of the two
trees) each tree wins.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_RUN = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
sys.path.insert(0, sys.argv[2])  # the package under test, ahead of ours
card = C.device_phase(torch)
from repro_torch.kernels import _build
_build.build_all(["mamba_scan"])
print("RESULT " + json.dumps(dict(card=card, **C.scan_timing(torch))))
"""

CASE = ("model", "dtype", "B", "S", "H", "G", "N")


def summary(path: str) -> None:
    import numpy as np
    runs = [json.loads(l) for l in Path(path).read_text().splitlines()
            if l.strip()]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    pairs = [(runs[i], runs[i + 1]) for i in range(0, len(runs) - 1, 2)]
    print(f"{len(runs)} runs, {len(pairs)} pairs; card {runs[0]['card']}")
    for metric in ("ms", "graph_ms"):
        ms = lambda run: {tuple(r[k] for k in CASE): r[metric]
                          for r in run["rows"]}
        for case in ms(runs[0]):
            line = [metric + " " + " ".join(map(str, case))]
            for tree in trees:
                med = float(np.median([ms(r)[case] for r in runs
                                       if r["tree"] == tree]))
                wins = sum(ms(a)[case] < ms(b)[case] for p in pairs
                           for a, b in (p, p[::-1]) if a["tree"] == tree)
                line.append(f"{tree}: median {med:.5f} ms, wins {wins} of "
                            f"{len(pairs)}")
            print(" | ".join(line))


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "--summary":
        summary(argv[1])
        return 0
    for tree in argv:
        src = Path(tree).resolve() / "src"
        out = subprocess.run(
            [sys.executable, "-c", _RUN, str(ROOT), str(src)], cwd=ROOT,
            capture_output=True, text=True)
        lines = [l for l in out.stdout.splitlines()
                 if l.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        print(json.dumps(dict(tree=str(tree), **json.loads(lines[-1][7:]))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
