"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles each ``pygenray_tpu_torch/csrc/<name>.cu``
into its own shared library with a plain C interface under
``pygenray_tpu_torch/_build/``, one ``nvcc`` per source, all started
together; a file name carries a hash of its source, the shared headers
(``*.cuh``) and the flags, so an edited source builds anew.  Each library
is loaded with ``ctypes``.  No PyTorch headers are involved, so a build
takes seconds (10 to 15 on the H100's host for the five, in parallel).

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build", "load", "find_nvcc", "sources", "NVCC_FLAGS"]

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

_LIBS = {}
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


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpygenray_{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel source whose library for the current sources
    is missing, one ``nvcc`` each, in parallel; returns {name: path}."""
    global BUILD_LOG
    paths = {name: library_path(name) for name in sources()}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, so in todo.items():
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out = proc.communicate()[0]
        logs.append(f"== {name}.cu\n{out}")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (exit {proc.returncode})")
        else:
            # atomic: a concurrent loader never sees a partial file
            os.replace(tmp, todo[name])
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{BUILD_LOG}")
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build()[name]))
    return lib
