"""The edge-MLP chain kernels (csrc/edge_mlp_{fwd,bwd}.cu) run on the CPU
through the CUDA stand-in, driven through the port's own wrapper
(kernels/edge_mlp.py: the route rule, prepare, launch, the autograd
Function) and held against the plain version: the forward and the gradient
of every input, on every route of the rule (on the stand-in's 3 SMs): the
register route in one block and in several (pf 8-64, R 1 to past 200),
the panel route in one block (pf 81) and in clusters of 2 and 4 with
distributed shared memory (pf 144, 256), the l2 route (W_s and the
backward's stash in device memory: pf 625, and pf 81 and 144 on a card
reporting less shared memory, in several clusters), the ×50 tail and
none, 0 to 3 head layers, ragged row counts. Each case runs the kernels
twice and asks for the same bits (the backward's cross-block counters
reset themselves). A rehearsal before a chip call; timings mean nothing
here. Run from the repository root:

    python scripts/cuda_emu/check_edge_mlp.py [--asan]

which builds the two libraries first. Exits non-zero when a case
disagrees beyond 1e-4 (scaled by each leaf's max abs for the gradients).
"""

import os
import sys
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import edge_mlp as M               # noqa: E402
from mpnn_tpu_torch.ops.message import edge_mlp_head_dims      # noqa: E402
from test_torch_gpu import mlp_chain                           # noqa: E402


def case(seed, rows, ef, nf, tail, budget=None):
    """The chain of an edge network with edge width ef at node width nf
    (the zoo's head schedule; no head when ef² >= nf²), on `rows` vocab
    rows; `budget`: the shared memory a block the card reports."""
    props = torch.cuda.get_device_properties
    if budget:
        torch.cuda.get_device_properties = lambda d: types.SimpleNamespace(
            shared_memory_per_block_optin=budget, multi_processor_count=3)
    M._SHAPES.clear()
    try:
        return _case(seed, rows, ef, nf, tail)
    finally:
        torch.cuda.get_device_properties = props
        M._SHAPES.clear()


def _case(seed, rows, ef, nf, tail):
    rng = np.random.RandomState(seed)
    head, pf = edge_mlp_head_dims(ef, nf, nf)
    t = lambda a: torch.tensor(a, requires_grad=True)
    if head:
        x, ws, bs, sw = mlp_chain(rng, rows, head, tail)
    else:
        x = rng.randn(rows, ef).astype(np.float32)
        x[-1] = 0.0
        ws, bs = [], []
        base = 0.7 * np.eye(pf) + 0.3 * np.linalg.qr(rng.randn(pf, pf))[0]
        for scale in np.arange(0.9, 2.0, 0.05):     # as mlp_chain's
            h = x
            for _ in range(tail):
                h = np.maximum(h @ (scale * base), 0.0)
            if 0.3 <= np.abs(h).max() <= 30:
                break
        sw = (scale * base).astype(np.float32)
    x, ws, bs, sw = t(x), [t(w) for w in ws], [t(b) for b in bs], t(sw)
    leaves = [x, *ws, *bs, sw]
    cw = torch.tensor(rng.randn(rows, pf), dtype=torch.float32)
    dims = [ef] + [o for _, o in head]

    def run(fn):
        pen = fn(x, ws, bs, sw, tail=tail)
        gs = torch.autograd.grad((pen * cw).sum(), leaves,
                                 allow_unused=True)
        return pen.detach(), [torch.zeros_like(v) if g is None else g
                              for v, g in zip(leaves, gs)]
    M.reset_launch_counts()
    got = run(M.edge_mlp)
    assert M.launch_counts == {"edge_mlp_fwd": 1, "edge_mlp_bwd": 1}, \
        M.launch_counts
    again = run(M.edge_mlp)
    same = all(torch.equal(a, b) for a, b in zip([got[0], *got[1]],
                                                 [again[0], *again[1]]))
    want = run(M.edge_mlp_reference)
    scale = float(want[0].abs().max()) or 1.0
    ef_ = float((got[0] - want[0]).abs().max()) / scale
    eb = max(float(((a - b) / (float(b.abs().max()) or 1.0)).abs().max())
             for a, b in zip(got[1], want[1]))
    ok = same and max(ef_, eb) < 1e-4 and all(torch.isfinite(g).all()
                                              for g in got[1])
    tags = " / ".join(M.device_shape(d, rows, dims, tail, "cpu").tag()
                      for d in ("fwd", "bwd"))
    print(f"rows={rows} ef={ef} nf={nf} H={len(head)} pf={pf} T={tail} "
          f"[{tags}]: fwd {ef_:.2e} (of max {scale:.2e}) bwd {eb:.2e}"
          f"{'' if same else ' (a second run differs)'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


# (seed, rows, ef, nf, tail): every route of the rule on 3 SMs
CASES = [(0, 9, 2, 8, 50),            # encoded: 2 → 4 → 16, pf 16
         (1, 14, 6, 7, 50),           # bench's bfm 6: pf 36, one block
         (2, 65, 7, 10, 50),          # bfm 7: pf 49, a full vocab, blocks
         (3, 23, 8, 32, 50),          # the reference's bfm 8: pf 64
         (4, 1, 6, 7, 50),            # only the zero row
         (5, 203, 6, 7, 6),           # past one block by far: pf 36
         (6, 5, 8, 2, 50),            # no head: pf 8
         (7, 6, 6, 7, 0),             # no tail
         (8, 13, 3, 10, 4),           # pf 81: the panel route, one block
         (9, 10, 12, 13, 50),         # pf 144: a cluster of 2 (backward)
         (10, 11, 4, 19, 50),         # bfm 4 at f 19: pf 256, clusters
         (11, 3, 2, 17, 2),           # pf 256 from ef 2, 3 head layers
         (12, 9, 5, 26, 3),           # pf 625 (5 → 25 → 625): the l2 route
         # the l2 route in several clusters, on a card reporting 20 and 12
         # KB of shared memory: pf 144, and pf 81 (rank 7 owns no column)
         (13, 10, 12, 13, 50, 20 * 1024),
         (14, 10, 3, 10, 4, 12 * 1024)]


def main(argv) -> int:
    emu.build(["edge_mlp_fwd:FwdArgs", "edge_mlp_bwd:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(M)
    return 0 if all([case(*c) for c in CASES]) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
