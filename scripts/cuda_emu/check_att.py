"""The adv model's message + GRU kernels (csrc/fused_att_fwd.cu,
csrc/fused_att_bwd.cu) run on the CPU through the CUDA stand-in, driven
through the port's own wrappers (kernels/fused_att.py: prepare, launch,
the autograd Function) and held against the plain version: the forward,
the serving launch and every gradient leaf, with and without the 'att'
correction, both width builds, K up to 64, and every forced launch of the
backward (chip_smoke.py::_adv_bwd_route: the rule's, a block per 8 and 64
slots, one block, every tile in global scratch; the stand-in runs a
thread per CUDA thread, so no more than ~20 blocks a launch), the
backward run twice for the same bits. A rehearsal before a chip call; timings mean nothing
here. Run from the repository root:

    python scripts/cuda_emu/check_att.py [--asan]

(~1 min; it builds the libraries first). Exits non-zero when a case
disagrees beyond 1e-4 (scaled by each leaf's max abs for the gradients) or
the bits differ.
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
from mpnn_tpu_torch.kernels import fused_att as A              # noqa: E402
from test_torch_gpu import _problem                            # noqa: E402

GRU = ("w_ih", "w_hh", "b_ih", "b_hh")


def case(seed, g, f, k, corr, route=None, big=0):
    rng = np.random.RandomState(seed)
    (_, _, _, h0, mask, ng, gru, _, _, _, _, _, vid, src, dst,
     plan) = _problem(rng, g=g, f=f, od=4, k=k, device="cpu", big=big)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))
    w = [t(rng.randn(k, f, f) * 0.3), t(rng.randn(f, f) * 0.3),
         t(rng.randn(k, f)), t(rng.randn(f)), t(rng.randn(f, f) * 0.5)]
    leaves = w + [gru[n] for n in GRU] + [h0]
    for x in leaves:
        x.requires_grad_(True)
    cw = t(rng.randn(*h0.shape))
    batch = (mask, ng, vid, src, dst, *plan)

    def grads(h):
        gs = torch.autograd.grad((h * cw).sum(), leaves, allow_unused=True)
        return [torch.zeros_like(x) if g_ is None else g_
                for x, g_ in zip(leaves, gs)]
    A.reset_launch_counts()
    tag = A.K.width_bucket("", A.BUCKETS, f=f, K=k)
    with CS._adv_bwd_route(route):
        h = A._FusedAtt.apply(corr, True, *leaves, *batch)
        got = grads(h)
        got2 = grads(A._FusedAtt.apply(corr, True, *leaves, *batch))
        with torch.no_grad():
            served = A._FusedAtt.apply(corr, False, *leaves, *batch)
        shape = A.device_bwd_shape(h0.shape[0], tag, k, g, "cpu")
    assert A.launch_counts == {"fused_att_fwd": 3,
                               "fused_att_bwd": 2}, A.launch_counts
    same = all(torch.equal(a, b) for a, b in zip(got, got2))
    ref = A.fused_att_reference(*w, h0, mask, ng, dict(zip(GRU, leaves[5:9])),
                                vid, src, dst, plan, with_corr=corr)
    want = grads(ref)
    ef = float((h - ref).detach().abs().max())
    es = float((served - ref).detach().abs().max())
    eb = max(float(((a - b) / (float(b.abs().max()) or 1.0)).abs().max())
             for a, b in zip(got, want))
    ok = (max(ef, es, eb) < 1e-4 and same
          and all(torch.isfinite(a).all() for a in got))
    print(f"g={g} f={f} K={k} corr={corr} route {route} ({shape.tag()}): "
          f"fwd {ef:.2e} serving {es:.2e} bwd {eb:.2e} bits "
          f"{'same' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def main(argv) -> int:
    emu.build([f"{emu.B.library(n, tag)}:{args}"
               for n, args in (("fused_att_fwd", "FwdArgs"),
                               ("fused_att_bwd", "BwdArgs"))
               for tag in ("", "f32")], asan="--asan" in argv)
    emu.emulate(A)
    oks = [case(0, 12, 7, 8, True),
           case(1, 12, 7, 8, False),
           case(2, 9, 16, 5, True),
           case(3, 9, 5, 64, True),
           # every forced launch, both buckets, with and without the
           # correction, a graph past a block's tile
           case(4, 6, 7, 8, True, route="nodes 8"),
           case(5, 12, 7, 8, False, route="nodes 64"),
           case(6, 12, 7, 8, True, route="one"),
           case(7, 12, 7, 8, True, route="spilled"),
           case(8, 6, 7, 8, True, big=400),
           case(9, 6, 7, 8, True, route="nodes 64", big=300),
           case(10, 9, 24, 5, True),
           case(11, 5, 27, 8, False, route="nodes 8"),
           case(12, 7, 32, 64, True, route="spilled", big=20),
           case(13, 5, 30, 64, True, route="one")]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
