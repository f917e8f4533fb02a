"""The att-steps kernels (csrc/fused_att_steps_{fwd,bwd}.cu) run on the CPU
through the CUDA stand-in, driven through the port's own wrappers
(kernels/fused_att_steps.py: prepare, launch, the autograd Function) and
held against the plain version: forward, serving launch and every
gradient leaf, in the four modes, both width builds and every forced route
of the backward (chip_smoke.py::_att_bwd_route: the rule's, clusters of
1-8 blocks, grids, the spilled tiles), the backward run twice
for the same bits. A rehearsal before a chip call; timings mean nothing
here. Run from the repository root:

    python scripts/cuda_emu/check_att_steps.py [--asan]

(~3 min; it builds the libraries first). Exits non-zero when a case
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
from mpnn_tpu_torch.kernels import fused_att_steps as AS       # noqa: E402
from test_torch_gpu import _problem                            # noqa: E402

GRU = ("w_ih", "w_hh", "b_ih", "b_hh")


def case(seed, g, f, k, tm, corr, norm, steps=3, route=None, big=0):
    rng = np.random.RandomState(seed)
    (_, _, _, h0, mask, ng, gru, _, _, _, _, _, vid, src, dst,
     plan) = _problem(rng, g=g, f=f, od=4, k=k, device="cpu", big=big)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))
    w = [t(rng.randn(tm, k, f, f) * 0.3), t(rng.randn(tm, f, f) * 0.3),
         t(rng.randn(tm, k, f)), t(rng.randn(tm, f)),
         t(rng.randn(tm, f, f) * 0.5)]
    leaves = w + [gru[n] for n in GRU] + [h0]
    for x in leaves:
        x.requires_grad_(True)
    cw = t(rng.randn(*h0.shape))
    meta = AS.AttsMeta(steps, corr, norm == "stateless")
    batch = (mask, ng, vid, src, dst, *plan)

    def grads(h):
        gs = torch.autograd.grad((h * cw).sum(), leaves, allow_unused=True)
        return [torch.zeros_like(x) if g_ is None else g_
                for x, g_ in zip(leaves, gs)]
    AS.reset_launch_counts()
    tag = AS.K.width_bucket("", AS.BUCKETS, f=f, K=k, steps=steps)
    # the stand-in's card holds 3 blocks at once (emu.py), and the grid
    # route refuses more
    with CS._att_bwd_route(route, 3 if route == "grid" else None):
        h = AS._FusedAttSteps.apply(meta, True, *leaves, *batch)
        got = grads(h)
        got2 = grads(AS._FusedAttSteps.apply(meta, True, *leaves, *batch))
        with torch.no_grad():
            served = AS._FusedAttSteps.apply(meta, False, *leaves, *batch)
        shape = AS.device_bwd_shape(h0.shape[0], tag, tm, k, steps,
                                    norm == "stateless", "cpu")
    assert AS.launch_counts == {"fused_att_steps_fwd": 3,
                                "fused_att_steps_bwd": 2}, AS.launch_counts
    same = all(torch.equal(a, b) for a, b in zip(got, got2))
    ref = AS.fused_att_steps_reference(
        *w, h0, mask, ng, dict(zip(GRU, leaves[5:9])), vid, src, dst, plan,
        steps=steps, with_corr=corr, state_norm=norm)
    want = grads(ref)
    ef = float((h - ref).detach().abs().max())
    es = float((served - ref).detach().abs().max())
    eb = max(float(((a - b) / (float(b.abs().max()) or 1.0)).abs().max())
             for a, b in zip(got, want))
    ok = (max(ef, es, eb) < 1e-4 and same
          and all(torch.isfinite(a).all() for a in got))
    print(f"g={g} f={f} K={k} Tm={tm} T={steps} corr={corr} {norm} route "
          f"{route} ({shape.tag()}): fwd {ef:.2e} serving {es:.2e} bwd "
          f"{eb:.2e} bits {'same' if same else 'DIFFER'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build([f"{emu.B.library(n, tag)}:FwdArgs".replace(
        "_bwd:FwdArgs", "_bwd:BwdArgs").replace(
        "_bwd.f32:FwdArgs", "_bwd.f32:BwdArgs")
        for n in ("fused_att_steps_fwd", "fused_att_steps_bwd")
        for tag in ("", "f32")], asan="--asan" in argv)
    emu.emulate(AS)
    oks = [case(0, 12, 7, 6, 3, False, "stateless"),
           case(1, 12, 7, 6, 3, False, "none"),
           case(2, 12, 7, 6, 1, False, "stateless"),
           case(3, 12, 7, 6, 3, True, "stateless"),
           case(4, 9, 16, 5, 3, True, "stateless"),
           case(5, 9, 5, 4, 1, True, "none", steps=4),
           # every forced route of the backward, both buckets, Tm 1 and T,
           # K 64, T 1 and 8, a graph past a block's tile
           case(6, 12, 7, 6, 3, True, "stateless", route="cluster 1"),
           case(7, 12, 7, 6, 3, True, "stateless", route="cluster 2"),
           case(8, 12, 7, 6, 1, True, "none", route="cluster 4"),
           case(9, 12, 7, 6, 3, True, "stateless", route="cluster 8"),
           case(10, 12, 7, 6, 3, True, "stateless", route="grid"),
           case(11, 12, 7, 6, 1, False, "stateless", route="grid 3"),
           case(12, 12, 7, 6, 3, True, "none", route="grid 2"),
           case(13, 6, 7, 6, 3, True, "stateless", route="spilled",
                big=40),
           case(14, 9, 24, 5, 3, True, "stateless", route="grid 3"),
           case(15, 9, 27, 4, 1, True, "none", route="cluster 2"),
           case(16, 7, 30, 64, 2, True, "stateless", steps=2,
                route="spilled", big=20),
           case(17, 9, 10, 64, 8, True, "stateless", steps=8),
           case(18, 9, 7, 6, 1, True, "stateless", steps=1,
                route="grid 2"),
           case(19, 4, 7, 6, 3, True, "stateless", big=300),
           # the wide bucket at K 64, Tm 8, T 8: a 9-node tile, A' from
           # device memory, larger graphs in global scratch
           case(20, 6, 27, 64, 8, True, "stateless", steps=8),
           case(21, 5, 32, 64, 8, True, "none", steps=8, route="grid 2")]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
