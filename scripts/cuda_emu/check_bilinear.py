"""The bilinear family's kernels (csrc/fused_bilinear_{fwd,bwd}.cu) run on
the CPU through the CUDA stand-in, driven through the port's own wrapper
(kernels/fused_bilinear.py: prepare, launch, the autograd Function) and
held against the plain version: the forward (training and serving
flavors, the serving one with no message stash) and the gradients of h0
and the GRU leaves, at f 2-4 and T 1-3 on ragged batches (graphs of 1 to
24 atoms, self-loops, padded edges). A rehearsal before a chip call;
timings mean nothing here. Run from the repository root:

    python scripts/cuda_emu/check_bilinear.py [--asan]

which builds the two libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (gradients scaled by each leaf's max abs).
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import fused_bilinear as B         # noqa: E402
from test_torch_gpu import bil_problem                         # noqa: E402


def run(fn, args, leaves, cw, steps):
    out = fn(*args, steps=steps)
    grads = torch.autograd.grad((out * cw).sum(), list(leaves.values()))
    return out.detach(), dict(zip(leaves, grads))


def case(seed, g, f, steps):
    rng = np.random.RandomState(seed)
    args, leaves = bil_problem(rng, g, f=f, device="cpu")
    cw = torch.tensor(rng.randn(args[1].shape[0], steps * f),
                      dtype=torch.float32)
    B.reset_launch_counts()
    got = run(B.fused_bilinear, args, leaves, cw, steps)
    want = run(B.fused_bilinear_reference, args, leaves, cw, steps)
    with torch.no_grad():
        served = B.fused_bilinear(*args, steps=steps)
    assert B.launch_counts == {"fused_bilinear_fwd": 2,
                               "fused_bilinear_bwd": 1}, B.launch_counts
    ef = float((got[0] - want[0]).abs().max())
    es = float((served - want[0]).abs().max())
    ok_f = all(bool(((x - want[0]).abs() <= 1e-5 + 1e-4 * want[0].abs())
                    .all()) for x in (got[0], served))
    eb = max(float(((got[1][k] - w) / (float(w.abs().max()) or 1.0))
                   .abs().max()) for k, w in want[1].items())
    ok = ok_f and eb < 1e-4 and all(torch.isfinite(x).all()
                                    for x in got[1].values())
    n = int(args[2].sum())
    print(f"G={g} f={f} T={steps} ({n} atoms, {args[5].shape[0]} edge "
          f"slots): fwd {ef:.2e} serving {es:.2e} bwd {eb:.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build(["fused_bilinear_fwd:FwdArgs", "fused_bilinear_bwd:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(B)
    oks = [case(0, 40, 2, 2),             # ecfp_bilinear's widths
           case(1, 40, 2, 1),
           case(2, 29, 3, 3),
           case(3, 17, 4, 2),
           case(4, 9, 2, 3)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
