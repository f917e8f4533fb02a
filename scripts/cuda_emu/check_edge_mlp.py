"""The edge-MLP chain kernels (csrc/edge_mlp_{fwd,bwd}.cu) run on the CPU
through the CUDA stand-in, driven through the port's own wrapper
(kernels/edge_mlp.py: prepare, launch, the autograd Function) and held
against the plain version: the forward and the gradient of every input,
at the widths the zoo produces (pf 16 to 256, 1 to 3 head layers, the
×50 tail and none, ragged row counts). A rehearsal before a chip call;
timings mean nothing here. Run from the repository root:

    python scripts/cuda_emu/check_edge_mlp.py [--asan]

which builds the two libraries first. Exits non-zero when a case
disagrees beyond 1e-4 (scaled by each leaf's max abs for the gradients).
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import edge_mlp as M               # noqa: E402
from mpnn_tpu_torch.ops.message import edge_mlp_head_dims      # noqa: E402
from test_torch_gpu import mlp_chain                           # noqa: E402


def case(seed, rows, ef, nf, tail):
    """The chain of an edge network with edge width ef at node width nf
    (the zoo's head schedule), on `rows` vocab rows."""
    rng = np.random.RandomState(seed)
    head, pf = edge_mlp_head_dims(ef, nf, nf)
    t = lambda a: torch.tensor(a, requires_grad=True)
    x, ws, bs, sw = mlp_chain(rng, rows, head, tail)
    x, ws, bs, sw = t(x), [t(w) for w in ws], [t(b) for b in bs], t(sw)
    leaves = [x, *ws, *bs, sw]
    cw = torch.tensor(rng.randn(rows, pf), dtype=torch.float32)

    def run(fn):
        pen = fn(x, ws, bs, sw, tail=tail)
        gs = torch.autograd.grad((pen * cw).sum(), leaves,
                                 allow_unused=True)
        return pen.detach(), [torch.zeros_like(v) if g is None else g
                              for v, g in zip(leaves, gs)]
    M.reset_launch_counts()
    got = run(M.edge_mlp)
    want = run(M.edge_mlp_reference)
    assert M.launch_counts == {"edge_mlp_fwd": 1, "edge_mlp_bwd": 1}, \
        M.launch_counts
    scale = float(want[0].abs().max()) or 1.0
    ef_ = float((got[0] - want[0]).abs().max()) / scale
    eb = max(float(((a - b) / (float(b.abs().max()) or 1.0)).abs().max())
             for a, b in zip(got[1], want[1]))
    ok = max(ef_, eb) < 1e-4 and all(torch.isfinite(g).all()
                                     for g in got[1])
    print(f"rows={rows} ef={ef} nf={nf} H={len(head)} pf={pf} T={tail}: "
          f"fwd {ef_:.2e} (of max {scale:.2e}) bwd {eb:.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build(["edge_mlp_fwd:FwdArgs", "edge_mlp_bwd:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(M)
    oks = [case(0, 9, 2, 8, 50),          # encoded: 2 → 4 → 16, pf 16
           case(1, 14, 6, 7, 50),         # bench's bfm 6: pf 36
           case(2, 65, 7, 10, 50),        # bfm 7: pf 49, a full vocab
           case(3, 23, 8, 32, 50),        # the reference's bfm 8: pf 64
           case(4, 11, 4, 19, 3),         # bfm 4 at f 19: pf 256
           case(5, 6, 6, 7, 0)]           # no tail
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
