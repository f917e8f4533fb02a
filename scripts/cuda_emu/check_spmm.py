"""The SpMM kernels (csrc/spmm_fwd.cu, csrc/spmm_da.cu) run on the CPU
through the CUDA stand-in, driven through the port's own op
(kernels/spmm.py: the layout check, the autograd Function, the device-
built source and vocab orders) and held against the plain version: the
forward, dh (the forward kernel on Aᵀ through the source order) and dA,
in the narrow (f <= 16, the used ids' A in shared memory) and the wide
bucket (f <= 32, A in device memory), on ragged batches with padded
edges, K 1 to 64, on the rule's tiles and the smallest ones
(chip_smoke.py::_spmm_route: the dummy row and a hub node of 300 edges
cross many tiles), each twice for the same bits. A rehearsal before a
chip call; timings mean nothing here. Run from the repository root:

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
from chip_smoke import (SPMM_ROUTES, _spmm_route,              # noqa: E402
                        spmm_hub_case, spmm_value_and_grads)
from test_torch_gpu import spmm_problem                        # noqa: E402


def close(got, want):
    return bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


def case(seed, g, f, k, route="rule", hub=0):
    rng = np.random.RandomState(seed)
    c = spmm_problem(rng, g, f=f, k=max(k, 2), device="cpu")
    if k == 1:
        # one vocab id: every edge takes A_0, nonzero here
        a = torch.as_tensor(rng.randn(1, f, f).astype(np.float32) * 0.3)
        c = (a, c[1], torch.zeros_like(c[2]), *c[3:])
    if hub:
        c = spmm_hub_case(c, hub, torch.Generator().manual_seed(seed))
    S.reset_launch_counts()
    with _spmm_route(**SPMM_ROUTES[route]):
        got = spmm_value_and_grads(S.spmm, *c)
        again = spmm_value_and_grads(S.spmm, *c)
        shape = S.device_shape(c[2].shape[0], f, f, c[0].shape[0], "cpu")
    assert S.launch_counts == {"spmm_fwd": 4, "spmm_da": 2}, S.launch_counts
    want = spmm_value_and_grads(lambda *x: S.spmm_reference(*x[:5]), *c)
    ef = float((got[0] - want[0]).abs().max())
    errs = {}
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = close(got[0], want[0]) and same
    for name, x, w in zip("ah", got[1:], want[1:]):
        scale = float(w.abs().max()) or 1.0
        errs[name] = float(((x - w) / scale).abs().max())
        ok = ok and close(x / scale, w / scale)
    print(f"G={g} f={f} K={k} hub {hub} {route} {shape.tag()} "
          f"({c[1].shape[0]} node slots, {c[2].shape[0]} edges): out "
          f"{ef:.2e} dA {errs['a']:.2e} dh {errs['h']:.2e}"
          f"{'' if same else ' BITS DIFFER'} {'ok' if ok else 'FAIL'}",
          flush=True)
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
           case(5, 5, 10, 20), case(6, 5, 10, 11), case(7, 5, 10, 20),
           # the smallest tiles: the dummy row over many tiles; a hub of
           # 300 edges; K 1; the wide bucket
           case(8, 40, 10, 7, "small tiles"),
           case(9, 30, 10, 8, "small tiles", hub=300),
           case(10, 30, 8, 1, hub=300), case(11, 12, 8, 1, "small tiles"),
           case(12, 17, 24, 64, "small tiles", hub=120)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
