"""Builds the port's CUDA kernels and loads them with ctypes.

Each source in `csrc/` is compiled by `nvcc` into shared libraries with a
plain C interface (no PyTorch headers, so a build takes seconds), into
`mpnn_tpu_torch/_build/` (listed in .gitignore). A source builds once per
width bucket: the narrow build every source has (tag ''), and the wide
buckets of WIDE, each its own library with `-D` width defines. A family's
libraries of one bucket build together, one concurrent `nvcc` each, the
first time one of them is loaded: a bucket no batch reaches is never
compiled. A library is rebuilt when its source or a shared header is
newer; nothing builds at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel source name → source file under csrc/
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
    "fused_att_steps_fwd": "fused_att_steps_fwd.cu",
    "fused_att_steps_bwd": "fused_att_steps_bwd.cu",
    "edge_mlp_fwd": "edge_mlp_fwd.cu",
    "edge_mlp_bwd": "edge_mlp_bwd.cu",
    "fused_bilinear_fwd": "fused_bilinear_fwd.cu",
    "fused_bilinear_bwd": "fused_bilinear_bwd.cu",
    "spmm_fwd": "spmm_fwd.cu",
    "spmm_da": "spmm_da.cu",
    "recurrence_fwd": "recurrence_fwd.cu",
    "recurrence_bwd": "recurrence_bwd.cu",
    "sddmm_fwd": "sddmm_fwd.cu",
    "sddmm_bwd": "sddmm_bwd.cu",
    "ro_bwd": "ro_bwd.cu",
    "msg_bwd": "msg_bwd.cu",
    "ps_walk_bwd": "ps_walk_bwd.cu",
}

# the sources that build and load together (one op module's kernels)
FAMILIES: Dict[str, Tuple[str, ...]] = {
    "fused_step": ("fused_eval", "fused_step_fwd", "fused_step_bwd"),
    "fused_psteps": ("fused_psteps_eval", "fused_psteps_fwd",
                     "fused_psteps_bwd"),
    "fused_att": ("fused_att_fwd", "fused_att_bwd"),
    "fused_att_steps": ("fused_att_steps_fwd", "fused_att_steps_bwd"),
    "set2vec": ("set2vec_fwd", "set2vec_bwd"),
    "edge_mlp": ("edge_mlp_fwd", "edge_mlp_bwd"),
    "fused_bilinear": ("fused_bilinear_fwd", "fused_bilinear_bwd"),
    "spmm": ("spmm_fwd", "spmm_da"),
    "recurrence": ("recurrence_fwd", "recurrence_bwd"),
    "sddmm": ("sddmm_fwd", "sddmm_bwd"),
    # the split training backward's three kernels (kernels/split_bwd.py)
    "split_bwd": ("ro_bwd", "msg_bwd", "ps_walk_bwd"),
}

# wide buckets: family → {tag: the -D defines of its libraries}. The
# narrow build (tag '') takes each source's own defaults: f <= 16 (od <= 16
# for the shared family, od <= 32 for the per-step one and the split
# backward), set2vec w <= 32, the bilinear family f <= 4 (its only bucket).
WIDE: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "fused_step": {"o64": ("MPNN_ODP=64",),
                   "f32": ("MPNN_FP=32", "MPNN_ODP=64"),
                   "o128": ("MPNN_FP=32", "MPNN_ODP=128")},
    "fused_psteps": {"f32": ("MPNN_FP=32", "MPNN_ODW=128")},
    "fused_att": {"f32": ("MPNN_FP=32",)},
    "fused_att_steps": {"f32": ("MPNN_FP=32",)},
    "set2vec": {"w64": ("MPNN_WP=64",)},
    "spmm": {"f32": ("MPNN_FP=32",)},
    "recurrence": {"f32": ("MPNN_FP=32",)},
    "sddmm": {"f32": ("MPNN_FP=32",)},
    "split_bwd": {"f32": ("MPNN_FP=32", "MPNN_ODW=128")},
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register / shared-memory report of the last build, per library
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def family_of(name: str) -> str:
    for fam, names in FAMILIES.items():
        if name in names:
            return fam
    raise KeyError(name)


def library(name: str, tag: str = "") -> str:
    """The library of source `name` in width bucket `tag`."""
    if tag and tag not in WIDE.get(family_of(name), {}):
        raise KeyError(f"{name} has no width bucket {tag!r}")
    return f"{name}.{tag}" if tag else name


def defines(lib: str) -> Tuple[str, ...]:
    name, _, tag = lib.partition(".")
    return WIDE[family_of(name)][tag] if tag else ()


def all_libraries() -> List[str]:
    """Every library: each source's narrow build and its wide buckets."""
    out = []
    for fam, names in FAMILIES.items():
        for tag in ("", *WIDE.get(fam, {})):
            out += [library(n, tag) for n in names]
    return out


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _so_path(lib: str) -> str:
    return os.path.join(BUILD_DIR, f"libmpnn_{lib}.so")


def _stale(lib: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header in csrc/."""
    so = _so_path(lib)
    deps = [os.path.join(CSRC, SOURCES[lib.partition(".")[0]])] + [
        os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    return not os.path.exists(so) or os.path.getmtime(so) < max(
        os.path.getmtime(d) for d in deps)


def build_all(libs: Optional[Iterable[str]] = None,
              force: bool = False) -> Dict[str, float]:
    """Compile the stale libraries of `libs` (default: every library), all
    nvcc processes started together. Returns seconds per library built;
    raises with nvcc's output on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    names = [n for n in (all_libraries() if libs is None else libs)
             if force or _stale(n)]
    nvcc = nvcc_path() if names else None
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        tmp = _so_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines(n)), "-o", tmp,
               os.path.join(CSRC, SOURCES[n.partition(".")[0]])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, _so_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str, tag: str = "") -> ctypes.CDLL:
    """The loaded library of source `name` in width bucket `tag`. At its
    first use, it and the other stale libraries of its family's bucket are
    built together."""
    lib_name = library(name, tag)
    with _LOCK:
        lib: Optional[ctypes.CDLL] = _LIBS.get(lib_name)
        if lib is None:
            if _stale(lib_name):
                build_all(library(n, tag)
                          for n in FAMILIES[family_of(name)])
            lib = ctypes.CDLL(_so_path(lib_name))
            _LIBS[lib_name] = lib
        return lib
