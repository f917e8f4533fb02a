"""Builds the port's CUDA kernels and loads them with ctypes.

Each source in `csrc/` is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
into `mpnn_tpu_torch/_build/` (listed in .gitignore). All sources build
concurrently, one `nvcc` process each. A library is rebuilt when its source
is newer; the build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel library name → source file under csrc/
SOURCES: Dict[str, str] = {
    "fused_eval": "fused_eval.cu",
    "fused_step_fwd": "fused_step_fwd.cu",
    "fused_step_bwd": "fused_step_bwd.cu",
    "fused_psteps_eval": "fused_psteps_eval.cu",
    "fused_psteps_fwd": "fused_psteps_fwd.cu",
    "fused_psteps_bwd": "fused_psteps_bwd.cu",
    "fused_att_fwd": "fused_att_fwd.cu",
    "fused_att_bwd": "fused_att_bwd.cu",
    "set2vec_fwd": "set2vec_fwd.cu",
    "set2vec_bwd": "set2vec_bwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register / shared-memory report of the last build, per library
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libmpnn_{name}.so")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header in csrc/."""
    so = _so_path(name)
    deps = [os.path.join(CSRC, SOURCES[name])] + [
        os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    return not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(d) for d in deps)


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every stale source, all nvcc processes started together.
    Returns seconds per library built; raises with nvcc's output on a
    failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = [n for n in SOURCES if force or _stale(n)]
    nvcc = nvcc_path() if names else None
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        tmp = _so_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
            continue
        os.replace(tmp, _so_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if missing or stale."""
    with _LOCK:
        lib: Optional[ctypes.CDLL] = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build_all()
            lib = ctypes.CDLL(_so_path(name))
            _LIBS[name] = lib
        return lib
