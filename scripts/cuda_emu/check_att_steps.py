"""The att-steps kernels (csrc/fused_att_steps_{fwd,bwd}.cu) run on the CPU
through the CUDA stand-in, driven through the port's own wrappers
(kernels/fused_att_steps.py: prepare, launch, the autograd Function) and
held against the plain version: forward, serving launch and every
gradient leaf, in the four modes and both width builds. A rehearsal before
a chip call; timings mean nothing here. Run from the repository root:

    python scripts/cuda_emu/emu.py fused_att_steps_fwd:FwdArgs \\
        fused_att_steps_bwd:BwdArgs
    python scripts/cuda_emu/check_att_steps.py

Exits non-zero when a case disagrees beyond 1e-4 (scaled by each leaf's
max abs for the gradients).
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

from emu import emulate                                        # noqa: E402
from mpnn_tpu_torch.kernels import fused_att_steps as AS       # noqa: E402
from test_torch_gpu import _problem                            # noqa: E402

GRU = ("w_ih", "w_hh", "b_ih", "b_hh")


def case(seed, g, f, k, tm, corr, norm, steps=3):
    rng = np.random.RandomState(seed)
    (_, _, _, h0, mask, ng, gru, _, _, _, _, _, vid, src, dst,
     plan) = _problem(rng, g=g, f=f, od=4, k=k, device="cpu")
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
    h = AS._FusedAttSteps.apply(meta, True, *leaves, *batch)
    got = grads(h)
    with torch.no_grad():
        served = AS._FusedAttSteps.apply(meta, False, *leaves, *batch)
    assert AS.launch_counts == {"fused_att_steps_fwd": 2,
                                "fused_att_steps_bwd": 1}, AS.launch_counts
    ref = AS.fused_att_steps_reference(
        *w, h0, mask, ng, dict(zip(GRU, leaves[5:9])), vid, src, dst, plan,
        steps=steps, with_corr=corr, state_norm=norm)
    want = grads(ref)
    ef = float((h - ref).detach().abs().max())
    es = float((served - ref).detach().abs().max())
    eb = max(float(((a - b) / (float(b.abs().max()) or 1.0)).abs().max())
             for a, b in zip(got, want))
    ok = max(ef, es, eb) < 1e-4 and all(torch.isfinite(a).all()
                                        for a in got)
    print(f"g={g} f={f} K={k} Tm={tm} corr={corr} {norm}: fwd {ef:.2e} "
          f"serving {es:.2e} bwd {eb:.2e} {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def main() -> int:
    emulate(AS)
    oks = [case(0, 12, 7, 6, 3, False, "stateless"),
           case(1, 12, 7, 6, 3, False, "none"),
           case(2, 12, 7, 6, 1, False, "stateless"),
           case(3, 12, 7, 6, 3, True, "stateless"),
           case(4, 9, 16, 5, 3, True, "stateless"),
           case(5, 9, 5, 4, 1, True, "none", steps=4)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
