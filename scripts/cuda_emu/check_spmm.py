"""The SpMM kernels (csrc/spmm_fwd.cu, csrc/spmm_da.cu) run on the CPU
through the CUDA stand-in, driven through the port's own op
(kernels/spmm.py: the layout check, the autograd Function, the device-
built source and vocab orders) and held against the plain version: the
forward, dh (the forward kernel on Aᵀ through the source order) and dA,
in the narrow (f <= 16, A in shared memory) and the wide bucket (f <= 32,
A in device memory), on ragged batches with padded edges. A rehearsal
before a chip call; timings mean nothing here. Run from the repository
root:

    python scripts/cuda_emu/check_spmm.py [--asan]

which builds the four libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (dA and dh scaled by their max abs).
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import spmm as S                   # noqa: E402
from chip_smoke import spmm_value_and_grads                   # noqa: E402
from test_torch_gpu import spmm_problem                        # noqa: E402


def close(got, want):
    return bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


def case(seed, g, f, k):
    rng = np.random.RandomState(seed)
    c = spmm_problem(rng, g, f=f, k=k, device="cpu")
    S.reset_launch_counts()
    got = spmm_value_and_grads(S.spmm, *c)
    assert S.launch_counts == {"spmm_fwd": 2, "spmm_da": 1}, S.launch_counts
    want = spmm_value_and_grads(lambda *x: S.spmm_reference(*x[:5]), *c)
    ef = float((got[0] - want[0]).abs().max())
    errs = {}
    ok = close(got[0], want[0])
    for name, x, w in zip("ah", got[1:], want[1:]):
        scale = float(w.abs().max()) or 1.0
        errs[name] = float(((x - w) / scale).abs().max())
        ok = ok and close(x / scale, w / scale)
    print(f"G={g} f={f} K={k} ({c[1].shape[0]} node slots, {c[2].shape[0]} "
          f"edges): out {ef:.2e} dA {errs['a']:.2e} dh {errs['h']:.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build(["spmm_fwd:FwdArgs", "spmm_da:DaArgs", "spmm_fwd.f32:FwdArgs",
               "spmm_da.f32:DaArgs"], asan="--asan" in argv)
    emu.emulate(S)
    oks = [case(0, 40, 10, 7),            # lipo's bench widths
           case(1, 23, 16, 8),
           case(2, 17, 24, 17),           # the wide bucket
           case(3, 9, 32, 64),
           case(4, 3, 10, 4),
           # one process, the narrow bucket at K 20, then 11, then 20
           # (sizes no case above took): the forward's shared-memory limit
           # must fit every K in turn
           case(5, 5, 10, 20), case(6, 5, 10, 11), case(7, 5, 10, 20)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
