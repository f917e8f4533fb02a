"""The fused recurrence kernels (csrc/recurrence_fwd.cu,
csrc/recurrence_bwd.cu) run on the CPU through the CUDA stand-in, driven
through the port's own op (kernels/recurrence.py: the checks, the
autograd Function, the residual stash) and held against the plain version
reference_recurrence: h_T, both statistics and every gradient leaf, in
the narrow (f <= 16) and the wide bucket (f <= 32), with a random mask;
each kernel on the route its rule picks and on every forced route
(chip_smoke.py::_rec_fwd_route and _rec_route: clusters of 1-8 blocks, a
grid, a 16-node tile that leaves blocks in global scratch), each twice
for the same bits; then the serving launch (no residuals); then, at GRU
weights past the init scale, the kernels against a float64 run. A rehearsal before a chip call;
timings mean nothing here. Run from the repository root:

    python scripts/cuda_emu/check_recurrence.py [--asan]

which builds the four libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (gradients scaled by each leaf's max abs).
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import recurrence as R             # noqa: E402
from chip_smoke import (_rec_fwd_route, _rec_route,           # noqa: E402
                        rec_case, rec_distances, rec_float64,
                        rec_value_and_grads)


def close(got, want):
    return bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


def case(seed, n, f, steps, route=None, grid=None, fwd=None, fwd_grid=None):
    args, leaves, g = rec_case(n, f, torch.Generator().manual_seed(seed),
                               "cpu")
    R.reset_launch_counts()
    tag = "" if f <= 16 else "f32"
    with _rec_route(route, grid), _rec_fwd_route(fwd, fwd_grid):
        got = rec_value_and_grads(R.recurrence, args, leaves, g, steps)
        again = rec_value_and_grads(R.recurrence, args, leaves, g, steps)
        shape = R.device_bwd_shape(n, tag, steps, "cpu")
        fshape = R.device_fwd_shape(n, tag, steps, "cpu")
        with torch.no_grad():
            served = R.recurrence(*args, steps=steps)[0]
    assert R.launch_counts == {"recurrence_fwd": 3, "recurrence_bwd": 2}
    same = all(torch.equal(x, y) for x, y in zip(
        [*got[0], *got[1].values()], [*again[0], *again[1].values()]))
    want = rec_value_and_grads(R.reference_recurrence, args, leaves, g,
                               steps)
    ok = all(close(x, y) for x, y in zip(got[0], want[0]))
    ef = max(float((x - y).abs().max()) for x, y in zip(got[0], want[0]))
    eb = 0.0
    for name, w in want[1].items():
        scale = float(w.abs().max()) or 1.0
        eb = max(eb, float(((got[1][name] - w) / scale).abs().max()))
        ok = ok and close(got[1][name] / scale, w / scale)
    ok = ok and close(served, want[0][0]) and same
    print(f"N={n} f={f} T={steps} fwd {fshape.tag()} bwd {shape.tag()}: "
          f"fwd+stats {ef:.2e} grads "
          f"{eb:.2e}{'' if same else ' BITS DIFFER'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def float64_case(seed, n, f, steps):
    """GRU weights N(0, 0.3²): the kernels within 1e-4 / 1e-5 of a float64
    run of the plain chain, the plain chain's distance beside them."""
    args, leaves, g = rec_case(n, f, torch.Generator().manual_seed(seed),
                               "cpu", weight_sd=0.3)
    exact = rec_float64(args, leaves, g, steps)
    ef, eg, ok = rec_distances(
        rec_value_and_grads(R.recurrence, args, leaves, g, steps), exact)
    pf, pg, _ = rec_distances(rec_value_and_grads(
        R.reference_recurrence, args, leaves, g, steps), exact)
    print(f"N={n} f={f} T={steps} N(0, 0.3²) weights vs float64: kernels "
          f"{ef:.2e} grads {eg:.2e}, plain {pf:.2e} grads {pg:.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main(argv) -> int:
    emu.build(["recurrence_fwd:RecFwdArgs", "recurrence_bwd:BwdArgs",
               "recurrence_fwd.f32:RecFwdArgs", "recurrence_bwd.f32:BwdArgs"],
              asan="--asan" in argv)
    emu.emulate(R)
    oks = [case(0, 256, 10, 4),           # TestRecurrence's shape
           case(1, 700, 10, 6),           # the grid of 3 blocks, ragged
           case(2, 300, 24, 3),           # the wide bucket
           case(3, 130, 32, 2),
           case(4, 40, 7, 1),
           # every forced route, narrow and wide
           *[case(6 + i, 200, 10, 3, route, 4 if route == "grid" else None)
             for i, route in enumerate(("cluster 1", "cluster 2",
                                        "cluster 4", "cluster 8", "grid",
                                        "spilled"))],
           case(12, 90, 30, 2, "cluster 4"),
           case(13, 90, 30, 2, "spilled"),
           case(14, 5, 10, 2, "cluster 8"),   # blocks without nodes
           # every forced route of the forward, narrow and wide, T up to
           # the kernels' 32 steps
           *[case(15 + i, 200, 10, 3, fwd=route,
                  fwd_grid=3 if route == "grid" else None)
             for i, route in enumerate(("cluster 1", "cluster 2",
                                        "cluster 4", "cluster 8", "grid",
                                        "spilled"))],
           case(21, 90, 30, 2, fwd="cluster 4"),
           case(22, 300, 27, 3, fwd="spilled"),
           case(23, 5, 10, 2, fwd="cluster 8"),  # blocks without nodes
           case(24, 120, 10, 32, fwd="grid", fwd_grid=3),
           float64_case(5, 700, 30, 6)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
