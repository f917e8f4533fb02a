"""Build the port's CUDA sources for the CPU stand-in of the CUDA runtime
(cuda_runtime.h beside this file) and point the kernel wrappers at them.

    python scripts/cuda_emu/emu.py [--asan] LIB:ARGS [LIB:ARGS ...]

LIB is a library of kernels/build.py (a source name, or `name.tag` for a
width bucket, compiled with that bucket's -D defines), ARGS the type of
the one argument struct of its cooperative kernels (fused_step_fwd:
FwdArgs; `<<<...>>>` launches need none: both of fused_eval's kernels
take mpnn_step::FwdArgs). Each becomes
mpnn_tpu_torch/_build/emu/libmpnn_LIB.so with the same C entry points as
the card's library; with --asan under AddressSanitizer (then run Python
with LD_PRELOAD=$(g++ -print-file-name=libasan.so)). The check scripts
beside this file import `build` and `emulate` from here.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import inspect
import os
import re
import shutil
import subprocess
import sys
import types
from typing import Dict, Iterable

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mpnn_tpu_torch.kernels import build as B                 # noqa: E402

OUT = os.path.join(B.BUILD_DIR, "emu")
SRC = os.path.join(OUT, "src")


def _stage_sources() -> None:
    """Copy csrc/ and rewrite what g++ cannot take: dynamic shared memory
    comes from the emulated block, a <<<...>>> launch calls emu_launch."""
    shutil.rmtree(SRC, ignore_errors=True)
    os.makedirs(SRC)
    for path in glob.glob(os.path.join(B.CSRC, "*.cu*")):
        with open(path) as fh:
            text = fh.read()
        text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float "
                      r"(\w+)\[\];", r"float* \1 = (float*)emu_smem();",
                      text)
        text = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\(([^;]*)\);",
                      lambda m: "emu_launch({}, {}, {});".format(
                          m.group(1), " ".join(m.group(2).split()),
                          m.group(3)), text, flags=re.S)
        with open(os.path.join(SRC, os.path.basename(path)), "w") as fh:
            fh.write(text)


def build(specs: Iterable[str], asan: bool = False) -> None:
    """Compile each LIB:ARGS spec, all g++ processes at once."""
    _stage_sources()
    flags = ["-std=c++20", "-O2", "-g", "-shared", "-fPIC"]
    if asan:
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
    procs: Dict[str, subprocess.Popen] = {}
    for spec in specs:
        lib, _, args = spec.partition(":")
        name = lib.partition(".")[0]
        unit = os.path.join(SRC, f"emu_{lib}.cpp")
        with open(unit, "w") as fh:
            for d in B.defines(lib):
                fh.write("#define {} {}\n".format(*d.split("=")))
            fh.write(f'#include "{B.SOURCES[name]}"\n'
                     f"static struct EmuInit {{ EmuInit() {{ emu_runner = "
                     f"&emu_run<{args}>; }} }} emu_init_;\n")
        procs[lib] = subprocess.Popen(
            ["g++", *flags, f"-I{HERE}", f"-I{SRC}", "-o",
             os.path.join(OUT, f"libmpnn_{lib}.so"), unit, "-lpthread"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for lib, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            failed.append(f"{lib}:\n{log}")
    if failed:
        raise RuntimeError("emulated build failed:\n" + "\n".join(failed))


def emulate(*modules) -> None:
    """Point the wrappers at the emulated libraries and let them take CPU
    tensors: no stream, no device context, and in each of `modules` no
    check that the tensors lie on a CUDA device, and no dispatch of CPU
    tensors to the plain version (the public ops launch the emulated
    kernels; call the *_reference functions for the plain version).
    Unwritten float outputs show as NaN."""
    libs = {}

    def load(name, tag=""):
        lib = B.library(name, tag)
        return libs.setdefault(lib, ctypes.CDLL(
            os.path.join(OUT, f"libmpnn_{lib}.so")))
    B.load = load
    torch = sys.modules["torch"]
    torch.cuda.current_stream = lambda *a: types.SimpleNamespace(
        cuda_stream=0)
    torch.cuda.current_device = lambda: 0
    torch.cuda.device = lambda d: contextlib.nullcontext()
    torch.cuda.get_device_properties = lambda d: types.SimpleNamespace(
        shared_memory_per_block_optin=232448,         # an H100's
        multi_processor_count=3)                      # cuda_runtime.h's
    for mod in modules:
        for name, fn in list(vars(mod).items()):
            if not inspect.isfunction(fn) or fn.__module__ != mod.__name__:
                continue
            src = inspect.getsource(fn)
            new = re.sub(r'[\w.]*device\.type (!= "cuda"|== "cpu")', "False",
                         src)
            if new != src:
                exec(new, mod.__dict__)
    empty = torch.empty

    def nan_empty(*a, **kw):
        t = empty(*a, **kw)
        if t.dtype == torch.float32:
            t.fill_(float("nan"))
        return t
    torch.empty = nan_empty


if __name__ == "__main__":
    argv = sys.argv[1:]
    asan = "--asan" in argv
    build([a for a in argv if a != "--asan"], asan=asan)
    print("\n".join(sorted(glob.glob(os.path.join(OUT, "*.so")))))
