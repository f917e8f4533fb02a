"""The folded-norm serving kernel (csrc/fused_eval.cu::fused_eval_kernel,
row 1) on the CPU through the CUDA stand-in: every width bucket (narrow,
o64, f32, o128), the four folded modes (message norm none or bn1d × state
norm none or bn1d), each forced route (chip_smoke.py::_eval_route) and
the rule's, on ragged batches with single-node graphs,
held against fused_eval_reference and run twice for the same bits. A
rehearsal before a chip call; timings mean nothing here. Run from the
repository root:

    python scripts/cuda_emu/check_fused_eval.py [--asan]

(~1 min). Exits non-zero when a case disagrees beyond rtol 1e-4 / atol
1e-5, the bits differ, or a launch count is off.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [HERE, os.path.join(ROOT, "tests"), ROOT]

import chip_smoke as CS                                        # noqa: E402
import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import fused_step as K             # noqa: E402
import test_torch_gpu as T                                     # noqa: E402

MODES = [("bn1d", "bn1d"), ("bn1d", "none"), ("none", "bn1d"),
         ("none", "none")]
ROUTES = (None, "nodes 1", "nodes 40", "one", "spilled")


def check(seed, g, f, od, k, mn, sn, route, steps=3, big=0):
    rng = np.random.RandomState(seed)
    args = T._problem(rng, g=g, f=f, od=od, k=k, device="cpu", big=big)
    kw = dict(steps=steps, msg_norm=mn, state_norm=sn)
    K.reset_launch_counts()
    tag = K.width_bucket("", K.BUCKETS, f=f, od=od)
    with CS._eval_route(route):
        got = K.fused_eval(*args, **kw)
        got2 = K.fused_eval(*args, **kw)
        shape = K.device_eval_shape(args[3].shape[0], tag, k, steps, "cpu",
                                    args[15].graph_node_ptr.shape[0] - 1)
    want = K.fused_eval_reference(*args, **kw)
    ok = (torch.allclose(got, want, rtol=1e-4, atol=1e-5)
          and torch.equal(got, got2)
          and K.launch_counts["fused_eval"] == 2)
    print(f"{'ok  ' if ok else 'FAIL'} g={g} f={f} od={od} K={k} T={steps} "
          f"{mn}/{sn} bucket {tag or 'narrow'} route {route} "
          f"({shape.tag()}): err {float((got - want).abs().max()):.2e}",
          flush=True)
    return ok


def main(argv) -> int:
    asan = "--asan" in argv
    emu.build([f"{emu.B.library('fused_eval', t)}:mpnn_step::FwdArgs"
               for t in ("", *emu.B.WIDE.get("fused_step", {}))], asan=asan)
    emu.emulate(K)
    oks = []
    # every mode and route in the narrow bucket at lipo's widths
    for i, (mn, sn) in enumerate(MODES):
        for route in ROUTES:
            oks.append(check(i, 9, 10, 14, 6, mn, sn, route))
    # the wide buckets, a graph past a block's tile, T 1 and 8
    oks += [check(5, 7, 7, 28, 5, "bn1d", "bn1d", None),
            check(6, 7, 7, 28, 5, "none", "none", "spilled", steps=1),
            check(7, 7, 27, 54, 4, "bn1d", "none", None),
            check(8, 7, 27, 54, 4, "none", "bn1d", "nodes 1", steps=8),
            check(9, 7, 27, 108, 4, "bn1d", "bn1d", None),
            check(10, 7, 32, 128, 4, "none", "none", "one"),
            check(11, 4, 10, 14, 64, "bn1d", "bn1d", None, big=300),
            check(12, 1, 10, 14, 6, "none", "bn1d", None)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
