"""Build the CUDA sources under ``fusion_sim_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under ``fusion_sim_torch/build/``
(ignored by git) at first use, and ``ctypes`` loads it.  A library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.  Builds write to a temporary
name and rename, so concurrent builds never see a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
# -fmad=false: the kernels keep the plain PyTorch versions' rounding (no
# contraction of a*b + c into one FMA), so the two agree bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{tag[:12]}.so"


def start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns ``(process, temporary output, final path)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(job: tuple[subprocess.Popen, Path, Path]) -> str:
    """Wait for a build from ``start_build``; returns nvcc's report
    (registers, shared memory, spills) or raises with it."""
    proc, tmp, out = job
    report, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{report}")
    os.replace(tmp, out)
    return report


def build_all() -> dict[str, tuple[float, str]]:
    """Build every ``csrc/*.cu`` at once (one nvcc per source, all started
    together); returns ``{name: (seconds, nvcc report)}``."""
    t0 = time.perf_counter()
    jobs = {p.stem: start_build(p.stem) for p in sorted(CSRC.glob("*.cu"))}
    out = {}
    for name, job in jobs.items():
        report = finish_build(job) if job is not None else "(cached)"
        out[name] = (time.perf_counter() - t0, report)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        job = start_build(name)
        if job is not None:
            finish_build(job)
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
