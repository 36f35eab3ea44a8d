#!/usr/bin/env python3
"""Time the main path's multigrid runs of several versions of the port on
one CUDA card, in turns.

    python3 tools/thermal_ab.py PARENT_DIR . . PARENT_DIR

Each argument is the root of a checkout whose ``src/repro_torch`` is the
package under test; the timing is this checkout's
``chip_smoke.thermal_timing`` (Table II, mcml and the 86-ambient LUT: one
warm-up, then the median wall of 5 runs with each run's solves, launches
and thermal host syncs, and one warm Table II run under the profiler), so
every version is measured by the same code. Each runs in a process of its
own, in the order given, which compares two versions on one card and one
host (parent, change, change, parent). It prints one JSON line per run with
the card's name and power limit.
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
_build.build_all(["thermal_stencil"])
print("RESULT " + json.dumps(dict(card=card, **C.thermal_timing(torch))))
"""


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
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
