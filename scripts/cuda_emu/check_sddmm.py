"""The attention SDDMM kernels (csrc/sddmm_fwd.cu, csrc/sddmm_bwd.cu) run on
the CPU through the CUDA stand-in, driven through the port's own op
(kernels/sddmm.py: the index check, the autograd Function, the device-
built source and vocab orders) and held against the plain version: the
forward and the five gradients (aprime, evocab, wa, ba, h), in the narrow
(f <= 16, aprime in shared memory) and the wide bucket (f <= 32, aprime in
device memory), on ragged batches whose padded edges end at the dummy
node with a nonzero aprime[0], h and cotangent there, and at mf != nf. A
rehearsal before a chip call; timings mean nothing here. Run from the
repository root:

    python scripts/cuda_emu/check_sddmm.py [--asan]

which builds the four libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (the gradients scaled by their max abs).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import sddmm as D                  # noqa: E402
from chip_smoke import sddmm_value_and_grads                  # noqa: E402
from test_torch_gpu import sddmm_problem                       # noqa: E402

NAMES = ("out", "d aprime", "d evocab", "d wa", "d ba", "dh")


def close(got, want):
    return bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


def case(seed, g, f, k, mf=None, ef=6):
    rng = np.random.RandomState(seed)
    c = sddmm_problem(rng, g, f=f, mf=mf, ef=ef, k=k, device="cpu")
    D.reset_launch_counts()
    got = sddmm_value_and_grads(D.sddmm, *c)
    assert D.launch_counts == {"sddmm_fwd": 1, "sddmm_bwd": 1}, \
        D.launch_counts
    want = sddmm_value_and_grads(lambda *x: D.sddmm_reference(*x[:8]), *c)
    ok, errs = True, []
    for i, (name, x, w) in enumerate(zip(NAMES, got, want)):
        scale = 1.0 if i == 0 else (float(w.abs().max()) or 1.0)
        errs.append(f"{name} {float(((x - w) / scale).abs().max()):.2e}")
        ok = ok and close(x / scale, w / scale)
    print(f"G={g} f={f} mf={mf or f} ef={ef} K={k} ({c[4].shape[0]} node "
          f"slots, {c[5].shape[0]} edges): " + ", ".join(errs)
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build(["sddmm_fwd:FwdArgs", "sddmm_bwd:BwdArgs",
               "sddmm_fwd.f32:FwdArgs", "sddmm_bwd.f32:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(D)
    oks = [case(0, 40, 7, 9),             # adv's bench widths
           case(1, 23, 16, 8),
           case(2, 17, 27, 64),           # the wide bucket, real widths
           case(3, 9, 32, 64, ef=32),
           case(4, 12, 10, 5, mf=13),     # mf != nf
           case(5, 3, 7, 4),
           # one process, the narrow bucket at K 20, then 11, then 20:
           # both kernels' shared-memory limits must fit every K in turn
           case(6, 5, 10, 20), case(7, 5, 10, 11), case(8, 5, 10, 20)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
