#!/usr/bin/env python3
"""Time the llama3.2-1b bf16 serve path of several versions of the port on
one CUDA card, in turns.

    python3 tools/serve_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout whose ``src/repro_torch`` is the
package under test; the timing is this checkout's
``chip_smoke.serve_timing`` (the bf16 traffic of ``chip_smoke.py`` served
once to warm up and once timed, its two repeating prompts through a
``speculate=3`` engine the same way, then the prefill step at B = 4,
S = 2048 over 3 calls, CUDA events), so every version is measured by the
same code. Each runs in a process of its own, in the order given, which
compares two versions on one card and one host (parent, change, change,
parent). It prints one JSON line per run: tokens/s, mean decode and
prefill tick, wall, the speculative run's tokens/s and drafts accepted,
prefill step ms, and the card's name and power limit.

    python3 tools/serve_ab.py --summary RUNS.jsonl

reads those lines back (two trees, in the P C C P order they ran) and
prints, for each metric, each tree's median and quartiles and the count of
pairs (consecutive runs of the two trees) each tree wins.
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
C.device_phase(torch)
C.build_phase()
print("RESULT " + json.dumps(C.serve_timing(torch)))
"""


# metric -> True where higher is better
METRICS = {"tokens_per_s": True, "decode_tick_s": False,
           "prefill_tick_s": False, "prefill_step_ms": False,
           "spec_tokens_per_s": True}


def summary(path: str) -> None:
    import numpy as np
    runs = [json.loads(l) for l in Path(path).read_text().splitlines()
            if l.strip()]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    pairs = [(runs[i], runs[i + 1]) for i in range(0, len(runs) - 1, 2)]
    print(f"{len(runs)} runs, {len(pairs)} pairs; card {runs[0]['card']}")
    for metric, higher in METRICS.items():
        if metric not in runs[0]:
            continue
        line = [metric]
        for tree in trees:
            v = np.array([r[metric] for r in runs if r["tree"] == tree])
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            wins = sum(
                (a[metric] > b[metric]) == higher and a[metric] != b[metric]
                for p in pairs for a, b in (p, p[::-1]) if a["tree"] == tree)
            line.append(f"{tree}: median {med:.6g} (quartiles {q1:.6g}-"
                        f"{q3:.6g}), wins {wins} of {len(pairs)}")
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
        print(json.dumps(dict(tree=str(tree), **json.loads(lines[-1][7:]))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
