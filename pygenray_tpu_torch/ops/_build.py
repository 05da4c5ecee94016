"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``pygenray_tpu_torch/csrc/*.cu`` into
one shared library with a plain C interface under
``pygenray_tpu_torch/_build/``; the file name carries a hash of the sources
and flags, so an edited source builds anew.  The library is loaded with
``ctypes``.  No PyTorch headers are involved, so a build takes seconds.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load", "find_nvcc", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper.  No --use_fast_math: Kahan summation needs IEEE add
# order, and 1/c, sqrt, sin and cos must stay IEEE-accurate.  -fmad=false
# keeps nvcc from contracting a*b+c into one fused multiply-add: torch's
# separate elementwise kernels round the product and the sum apart, and
# with contraction the kernel's travel times drift up to 8e-5 s from its
# plain version's at the headline fan (on an H100; PERF.md), against
# bitwise agreement without it.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
BUILD_LOG = ""  # nvcc's output (ptxas register/spill report) of the last build


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME / CUDA_PATH, else the
    toolkit's default install location."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use and need the "
        "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpygenray_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for the current sources exists;
    returns its path."""
    global BUILD_LOG
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cu]
    r = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = r.stdout + r.stderr
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB
