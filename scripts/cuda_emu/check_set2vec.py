"""The set2vec readout kernels (csrc/set2vec_fwd.cu, csrc/set2vec_bwd.cu)
run on the CPU through the CUDA stand-in (3 emulated SMs), driven through
the port's own op (kernels/set2vec.py: the route rule, the autograd
Function) and held against the plain version: the forward and every
gradient leaf (the readout's ten and x), in both softmax modes, on each
route — one block, a block per SM, rows streamed in chunks (the card's
shared memory reported lower at w 14), the backward's leaf accumulator
in global scratch (every wide case; 44 graphs a block at w 32), the
graphs' slots in global scratch (the spilled route: the backward at 14
graphs a block at w 54, both kernels at 77 a block at w 64) — at w 14,
32, 54 and 64, on ragged batches
with single-node graphs and a block whose graphs are all empty; then the
empty-step floor kernel. A rehearsal before a chip call; timings mean
nothing here. Run from the repository root:

    python scripts/cuda_emu/check_set2vec.py [--asan]

which builds the four libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (the gradients scaled by their max abs).
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
from mpnn_tpu_torch.kernels import fused_step as K             # noqa: E402
from mpnn_tpu_torch.kernels import set2vec as S                # noqa: E402
from test_torch_gpu import s2v_sizes_problem                   # noqa: E402


def close(got, want):
    return bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


def value_and_grads(fn, args, leaves, cw, **kw):
    out = fn(*args, **kw)
    grads = torch.autograd.grad((out * cw).sum(), list(leaves.values()))
    return [out.detach(), *grads]


def case(name, sizes, w, steps, batch_softmax, budget=None):
    if budget:                 # a card with less shared memory a block
        torch.cuda.get_device_properties = lambda d: types.SimpleNamespace(
            shared_memory_per_block_optin=budget, multi_processor_count=3)
    try:
        return _case(name, sizes, w, steps, batch_softmax)
    finally:
        torch.cuda.get_device_properties = PROPS


def _case(name, sizes, w, steps, batch_softmax):
    rng = np.random.RandomState(len(sizes) + w + steps)
    args, leaves = s2v_sizes_problem(rng, sizes, w=w, device="cpu")
    n, g = args[1].shape[0], len(sizes)
    ptr = args[4].numpy()
    routes = []
    for d in ("fwd", "bwd"):
        sh = S.device_shape(d, n, g, w, "cpu")
        routes.append(f"{d} {sh.tag(ptr)} grid {sh.grid} warps {sh.warps} "
                      f"cap {sh.cap}")
    cw = torch.as_tensor(rng.randn(g, 2 * w).astype(np.float32))
    kw = dict(time_steps=steps, batch_softmax=batch_softmax)
    S.reset_launch_counts()
    got = value_and_grads(S.set2vec, args, leaves, cw, **kw)
    assert S.launch_counts == {"set2vec_fwd": 1, "set2vec_bwd": 1}, \
        S.launch_counts
    want = value_and_grads(S.set2vec_reference, args, leaves, cw, **kw)
    ok, errs = True, []
    for i, (leaf, x, wv) in enumerate(zip(["m", *leaves], got, want)):
        scale = 1.0 if i == 0 else (float(wv.abs().max()) or 1.0)
        errs.append(float(((x - wv) / scale).abs().max()))
        ok = ok and close(x / scale, wv / scale) and bool(x.isfinite().all())
    print(f"{name} G={g} N={n} w={w} T={steps} "
          f"{'global' if batch_softmax else 'per-graph'} ({'; '.join(routes)})"
          f": m {errs[0]:.2e}, leaves max {max(errs[1:]):.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def floor_case(n, g, w, steps):
    p = S.prepare_barrier_floor(n, g, w, steps, "cpu")
    (out,) = K.launch_prepared(p)
    sh = S.device_shape("fwd", n, g, w, "cpu")
    ok = float(out[0]) == float(steps * sh.grid if sh.grid > 1 else steps)
    print(f"floor G={g} grid {sh.grid}: Σ over {steps} steps of the "
          f"combined sum {float(out[0])} {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def main(argv) -> int:
    emu.build(["set2vec_fwd:FwdArgs", "set2vec_bwd:BwdArgs",
               "set2vec_fwd.w64:FwdArgs", "set2vec_bwd.w64:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(S)
    global PROPS
    PROPS = torch.cuda.get_device_properties
    rng = np.random.RandomState(0)
    ragged = lambda g: np.concatenate([[1, 1, 1], rng.randint(1, 25, g - 3)])
    empty_block = ragged(36)
    empty_block[12:24] = 0                   # block 1 of 3: no real node
    big = ragged(40)
    big[[4, 18, 30]] = 600
    big_wide = ragged(27)              # the wide backward: 9 graphs a block
    big_wide[[4, 14, 22]] = 600
    oks = []
    for bsm in (True, False):
        oks += [case("one-block", ragged(9), 14, 3, bsm),
                case("grid", ragged(40), 14, 3, bsm),
                case("empty-block", empty_block, 14, 3, bsm),
                case("chunked", big, 14, 3, bsm, budget=48 * 1024),
                case("one-block", ragged(9), 54, 3, bsm),
                case("grid", ragged(12), 64, 2, bsm),
                case("grid-global-acc", ragged(130), 32, 2, bsm),
                case("one-block", ragged(12), 32, 2, bsm),
                case("chunked", big_wide, 54, 2, bsm),
                case("spilled-bwd", ragged(40), 54, 2, bsm),
                case("spilled", ragged(230), 64, 2, bsm)]
    oks += [floor_case(300, 9, 14, 4), floor_case(600, 40, 14, 4)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
