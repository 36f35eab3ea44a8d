"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each source is compiled at first use into a shared library with a plain C
interface, under ``build/kernels/`` at the repository root, keyed by a hash
of the source and the flags, and loaded with ``ctypes``; ``build_all``
starts one ``nvcc`` per source at once. The sources include no PyTorch
headers, so a build takes seconds. ``nvcc -Xptxas -v`` reports
each kernel's registers, shared memory and spills; the report is kept beside
the library (``build_log``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no contraction into fused multiply-adds: the kernels round every
    # operation as their plain PyTorch versions do
    "-fmad=false",
    "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or the default
    toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc was not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    # the shared headers too: a source that includes one is rebuilt when it
    # changes
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = BUILD_DIR / f"{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's library exists."""
    return build_all([name])[name]


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` per source, all started together; return {name: library}."""
    jobs, out = [], {}
    for name in names:
        src, so, log = _paths(name)
        out[name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, so, log, tmp, proc))
    failed = []
    for src, so, log, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        log.write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{stderr}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``) of the last build of ``name``."""
    build(name)
    return _paths(name)[2].read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
