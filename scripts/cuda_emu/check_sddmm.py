"""The attention SDDMM kernels (csrc/sddmm_fwd.cu, csrc/sddmm_bwd.cu) run on
the CPU through the CUDA stand-in, driven through the port's own op
(kernels/sddmm.py: the index check, the autograd Function, the device-
built node and vocab orders) and held against the plain version: the
forward and the five gradients (aprime, evocab, wa, ba, h), in the narrow
(f <= 16, aprime in shared memory) and the wide bucket (f <= 32, aprime in
device memory), on ragged batches whose padded edges end at the dummy
node with a nonzero aprime[0], h and cotangent there, and at mf != nf.
kernels/sddmm.py::launch_shape's tiles and forced ones: the smallest
tiles (a group one position: the dummy row and a hub node of hundreds of
edges cross many tiles, padded edges cross a tile boundary) and large
ones (a group up to 8 positions); each case runs twice and must give the
same bits. A rehearsal before a chip call;
timings mean nothing here. Run from the repository root:

    python scripts/cuda_emu/check_sddmm.py [--asan]

which builds the four libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (the gradients scaled by their max abs).
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import sddmm as D                  # noqa: E402
from chip_smoke import _sddmm_route, sddmm_value_and_grads     # noqa: E402
from test_torch_gpu import sddmm_problem                       # noqa: E402

NAMES = ("out", "d aprime", "d evocab", "d wa", "d ba", "dh")


def close(got, want):
    return bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


def case(seed, g, f, k, mf=None, ef=6, hub=0, per=None):
    rng = np.random.RandomState(seed)
    c = sddmm_problem(rng, g, f=f, mf=mf, ef=ef, k=k, device="cpu", hub=hub)
    e = c[5].shape[0]
    with _sddmm_route(per):
        shapes = [D.device_shape(d, e, c[0].shape[1], f, c[0].shape[0],
                                 "cpu").tag() for d in ("fwd", "bwd")]
        runs = []
        for _ in range(2):
            D.reset_launch_counts()
            runs.append(sddmm_value_and_grads(D.sddmm, *c))
            assert D.launch_counts == {"sddmm_fwd": 1, "sddmm_bwd": 1}, \
                D.launch_counts
    got = runs[0]
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    want = sddmm_value_and_grads(lambda *x: D.sddmm_reference(*x[:8]), *c)
    ok, errs = same, []
    for i, (name, x, w) in enumerate(zip(NAMES, got, want)):
        scale = 1.0 if i == 0 else (float(w.abs().max()) or 1.0)
        errs.append(f"{name} {float(((x - w) / scale).abs().max()):.2e}")
        ok = ok and close(x / scale, w / scale)
    pads = int((c[5] == 0).sum())
    sink = not pads or (bool(got[0][-1].abs().max() > 0)
                        and bool(got[5][-1].abs().max() > 0))
    ok = ok and sink
    print(f"G={g} f={f} mf={mf or f} ef={ef} K={k} hub={hub} "
          f"({c[4].shape[0]} node slots, {e} edges, {pads} padded; "
          f"{shapes[0]} / {shapes[1]}): " + ", ".join(errs)
          + f"; same bits {same}, dummy row {sink} "
          + f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build(["sddmm_fwd:FwdArgs", "sddmm_bwd:BwdArgs",
               "sddmm_fwd.f32:FwdArgs", "sddmm_bwd.f32:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(D)
    oks = [case(0, 40, 7, 9),             # adv's bench widths, the rule's
           case(0, 40, 7, 9, per=(8, 8)),     # a group 8 positions
           case(1, 12, 7, 9, per=(1, 1)),     # the smallest tiles
           case(2, 16, 7, 9, hub=150, per=(1, 1)),
           # a hub row over 19 tiles: its sum split over two lanes
           case(12, 30, 7, 9, hub=600, per=(1, 1)),
           case(2, 16, 7, 9, hub=150, per=(4, 2)),
           case(3, 4, 7, 9, per=(8, 8)),      # one tile a direction
           case(4, 23, 16, 8),
           case(4, 23, 16, 8, per=(1, 1)),
           case(5, 17, 27, 64),               # the wide bucket
           case(5, 17, 27, 64, per=(3, 2)),
           case(6, 9, 32, 64, ef=32),
           case(6, 9, 32, 64, ef=32, per=(8, 8)),
           case(7, 12, 10, 5, mf=13),         # mf != nf
           case(7, 12, 10, 5, mf=13, per=(1, 1)),
           case(8, 3, 7, 4),
           # one process, the narrow bucket at K 20, then 11, then 20:
           # both kernels' shared-memory limits must fit every K in turn
           case(9, 5, 10, 20), case(10, 5, 10, 11), case(11, 5, 10, 20)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
