"""Every ported kernel family at its narrow and its wide width bucket, run
on the CPU through the CUDA stand-in and driven through the port's own
wrappers (the public ops, their bucket choice, padding and autograd),
held against the plain versions: forward outputs, batch statistics and
every gradient leaf. A rehearsal before a chip call; timings mean nothing
here. Run from the repository root:

    python scripts/cuda_emu/check_wide.py [--asan] [family ...]

which builds the libraries it needs first (families: fused_step,
fused_psteps, fused_att, fused_att_steps, set2vec; default all). Exits
non-zero when a case disagrees beyond 1e-4 (scaled by each leaf's max abs
for the gradients).
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

TOL = 1e-4
# family → its libraries' argument structs
ARGS = {
    # fused_eval's cooperative kernel (the stateless norm) takes the
    # forward's args; its warp kernel's launch is rewritten per call
    "fused_step": {"fused_eval": "mpnn_step::FwdArgs",
                   "fused_step_fwd": "FwdArgs", "fused_step_bwd": "BwdArgs"},
    "fused_psteps": {"fused_psteps_eval": "PsFwdArgs",
                     "fused_psteps_fwd": "PsFwdArgs",
                     "fused_psteps_bwd": "PsBwdArgs"},
    "fused_att": {"fused_att_fwd": "FwdArgs", "fused_att_bwd": "BwdArgs"},
    "fused_att_steps": {"fused_att_steps_fwd": "FwdArgs",
                        "fused_att_steps_bwd": "BwdArgs"},
    "set2vec": {"set2vec_fwd": "FwdArgs", "set2vec_bwd": "BwdArgs"},
}


def _err(a, b):
    return float((a - b).detach().abs().max()) if a.numel() else 0.0


def _scaled(got, want):
    """Worst gradient error, each leaf divided by its max abs."""
    return max(float(((g - want[k]) / (float(want[k].abs().max()) or 1.0)
                      ).abs().max()) for k, g in got.items())


def _report(what, errs):
    ok = max(errs.values()) < TOL and all(np.isfinite(list(errs.values())))
    print(f"{what}: " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + (" ok" if ok else " FAIL"), flush=True)
    return ok


# the backward's routes, forced as the GPU tests force them
# (chip_smoke.py::_bwd_route) (one block, a
# cluster of 8, the grid, the grid with 16-node tiles: blocks keep their
# graphs in global scratch); None keeps the rule's choice
ROUTES = {None: None, "one": "cluster 1", "cluster": "cluster 8",
          "grid": "grid", "spilled": "spilled"}


def _stash(sargs, steps, msg_norm, state_norm):
    """The training forward's outputs through the wrapper (forward_
    residuals): (loss, out, stats, htil)."""
    (amat, a0, mbias, h0, mask, ng, gru, ma, bn, ro, labels, gmask, vid,
     src, dst, plan) = sargs
    det = lambda d: {k: (det(v) if isinstance(v, dict) else v.detach())
                     for k, v in d.items()}
    weights = K._flat_weights(amat.detach(), a0.detach(), mbias.detach(),
                              det(gru), det(ma), det(bn), det(ro))
    meta = K.StepMeta(steps, K.BATCH_BN if msg_norm == "bn1d" else K.NONE,
                      K._STATE_MODE[state_norm])
    return K.forward_residuals(weights, h0.detach(), mask, ng, labels, gmask,
                               vid, src, dst, plan, meta)


def check_fused_step(seed, g, f, od, k, msg_norm="bn1d", state_norm="bn1d",
                     steps=3, route=None, fwd=None, big=0):
    """Rows 1-3 through the public ops against their plain versions; the
    backward on `route` (ROUTES), the forward kernels on `fwd` (a route of
    chip_smoke.py::_fwd_route, None the rule's): the serving output, loss,
    out, every slot's statistics, the stash (padded slots zero) and the
    gradients, and the same bits again from a second forward."""
    rng = np.random.RandomState(seed)
    args = T._problem(rng, g=g, f=f, od=od, k=k, device="cpu", big=big)
    kw = dict(steps=steps, msg_norm=msg_norm, state_norm=state_norm)
    K.reset_launch_counts()
    with CS._fwd_route(fwd):
        got = K.fused_eval(*args, **kw)
        got2 = K.fused_eval(*args, **kw)
    want = K.fused_eval_reference(*args, **kw)
    sargs, leaves = T._step_problem(rng, g, f=f, od=od, k=k, device="cpu",
                                    big=big)
    cw = torch.as_tensor(rng.randn(g, od).astype(np.float32))
    tag = K.width_bucket('', K.BUCKETS, f=f, od=od)
    n = sargs[3].shape[0]
    with CS._bwd_route(ROUTES[route]), CS._fwd_route(fwd):
        sgot = T.step_and_grads(K.fused_step, sargs, leaves, cw, **kw)
        shape = K.device_bwd_shape(n, tag, k, steps, state_norm != "none",
                                   "cpu")
        fshape = K.device_fwd_shape(
            n, tag, k, steps, msg_norm != "none" or state_norm != "none",
            "cpu")
        stash = _stash(sargs, steps, msg_norm, state_norm)
        stash2 = _stash(sargs, steps, msg_norm, state_norm)
    swant = T.step_and_grads(K.fused_step_reference, sargs, leaves, cw, **kw)
    ref = K._reference_residuals(
        list(zip(K._GRAD_LEAVES, [x.detach() for x in (
            leaves["amat"], leaves["a0"], leaves["mbias"], leaves["w_ih"],
            leaves["w_hh"], leaves["b_ih"], leaves["b_hh"], leaves["ma_w"],
            leaves["ma_b"], leaves["bn_w"], leaves["bn_b"], leaves["ro_iw"],
            leaves["ro_ib"], leaves["ro_jw"], leaves["ro_jb"])])),
        sargs[3].detach(), *sargs[4:6], *sargs[10:16],
        K.StepMeta(steps, K.BATCH_BN if msg_norm == "bn1d" else K.NONE,
                   K._STATE_MODE[state_norm]))
    stateless = state_norm == "stateless"
    assert K.launch_counts == {"fused_eval": 2 * int(not stateless),
                               "fused_eval_stateless": 2 * int(stateless),
                               "fused_step_fwd": 3,
                               "fused_step_bwd": 1}, K.launch_counts
    assert CS._route_matches(fshape, fwd), fshape.tag()
    stats = max(_err(a, b) for a, b in zip(
        [*sgot[2], *(x for s in sgot[3] for x in s)],
        [*swant[2], *(x for s in swant[3] for x in s)]))
    grads = {n: v for n, v in sgot[4].items()
             if not (n == "mbias" and msg_norm == "bn1d")}
    n_real = int(sargs[4].sum())
    same = (torch.equal(got, got2)
            and all(torch.equal(a, b) for a, b in zip(stash, stash2)))
    errs = {"eval": _err(got, want), "loss": _err(sgot[0], swant[0]),
            "out": _err(sgot[1], swant[1]), "stats": stats,
            "htil": _err(stash[3], ref[3]),
            "pad": float(stash[3][:, n_real:].abs().max())
            if n > n_real else 0.0,
            "grads": _scaled(grads, swant[4]),
            "bits": 0.0 if same else 1.0}
    return _report(
        f"fused_step g={g} f={f} od={od} K={k} T={steps} "
        f"{msg_norm}/{state_norm} bucket {tag or 'narrow'} "
        f"fwd {fshape.tag()} bwd {shape.tag()}", errs)


def check_fused_psteps(seed, g, f, od, k, msg_norm, state_norm, steps=3):
    from mpnn_tpu_torch.kernels import fused_psteps as P
    rng = np.random.RandomState(seed)
    c, leaves = T._ps_problem(rng, g, f=f, od=od, k=k, steps=steps,
                              device="cpu")
    kw = dict(steps=steps, msg_norm=msg_norm, state_norm=state_norm)
    P.reset_launch_counts()
    with torch.no_grad():
        got = T._ps_eval(P.fused_psteps_eval, c, **kw)
        want = T._ps_eval(P.fused_psteps_eval_reference, c, **kw)
    cw = torch.as_tensor(rng.randn(g, od).astype(np.float32))
    sgot = T.ps_step_and_grads(P.fused_psteps, c, leaves, cw, **kw)
    swant = T.ps_step_and_grads(P.fused_psteps_reference, c, leaves, cw,
                                **kw)
    assert P.launch_counts == {"fused_psteps_eval": 1, "fused_psteps_fwd": 1,
                               "fused_psteps_bwd": 1}, P.launch_counts
    stats = max(_err(a, b) for a, b in zip(
        [x for s in [*sgot[2], *sgot[3]] for x in s],
        [x for s in [*swant[2], *swant[3]] for x in s]))
    grads = {n: v for n, v in sgot[4].items()
             if not (n == "mbias" and msg_norm == "bn1d")}
    return _report(
        f"fused_psteps g={g} f={f} od={od} K={k} T={steps} "
        f"{msg_norm}/{state_norm} bucket "
        f"{K.width_bucket('', P.BUCKETS, f=f, od=od, steps=steps) or 'narrow'}",
        {"eval": _err(got, want), "loss": _err(sgot[0], swant[0]),
         "out": _err(sgot[1], swant[1]), "stats": stats,
         "grads": _scaled(grads, swant[4])})


def _value_and_grads(fn, args, leaves, cw, **kw):
    out = fn(*args, **kw)
    gs = torch.autograd.grad((out * cw).sum(), list(leaves.values()),
                             allow_unused=True)
    return out.detach(), {k: torch.zeros_like(v) if g is None else g
                          for (k, v), g in zip(leaves.items(), gs)}


def _check_op(what, mod, fn, ref, args, leaves, cw, launches, tag, **kw):
    """An autograd op against its plain version: output, every gradient
    leaf, and the serving launch (no grad) against the same output."""
    mod.reset_launch_counts()
    got = _value_and_grads(fn, args, leaves, cw, **kw)
    want = _value_and_grads(ref, args, leaves, cw, **kw)
    with torch.no_grad():
        served = fn(*args, **kw)
    assert mod.launch_counts == launches, mod.launch_counts
    return _report(f"{what} bucket {tag or 'narrow'}",
                   {"fwd": _err(got[0], want[0]),
                    "serving": _err(served, want[0]),
                    "grads": _scaled(got[1], want[1])})


def check_fused_att(seed, g, f, k, with_corr):
    from mpnn_tpu_torch.kernels import fused_att as A
    rng = np.random.RandomState(seed)
    args, leaves = T._att_problem(rng, g, f=f, k=k, device="cpu")
    cw = torch.as_tensor(rng.randn(*args[5].shape).astype(np.float32))
    return _check_op(f"fused_att g={g} f={f} K={k} corr={with_corr}", A,
                     A.fused_att, A.fused_att_reference, args, leaves, cw,
                     {"fused_att_fwd": 2, "fused_att_bwd": 1},
                     K.width_bucket("", A.BUCKETS, f=f, K=k),
                     with_corr=with_corr)


def check_fused_att_steps(seed, g, f, k, tm, with_corr, norm, steps=3):
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    rng = np.random.RandomState(seed)
    args, leaves = T._atts_problem(rng, g, f=f, k=k, tm=tm, device="cpu")
    cw = torch.as_tensor(rng.randn(*args[5].shape).astype(np.float32))
    return _check_op(
        f"fused_att_steps g={g} f={f} K={k} Tm={tm} corr={with_corr} {norm}",
        AS, AS.fused_att_steps, AS.fused_att_steps_reference, args, leaves,
        cw, {"fused_att_steps_fwd": 2, "fused_att_steps_bwd": 1},
        K.width_bucket("", AS.BUCKETS, f=f, K=k, steps=steps), steps=steps,
        with_corr=with_corr,
        state_norm=norm)


def check_set2vec(seed, g, w, steps, batch_softmax):
    from mpnn_tpu_torch.kernels import set2vec as S
    rng = np.random.RandomState(seed)
    args, leaves = T._s2v_problem(rng, g, w=w, device="cpu")
    cw = torch.as_tensor(rng.randn(g, 2 * w).astype(np.float32))
    return _check_op(
        f"set2vec g={g} w={w} T={steps} batch_softmax={batch_softmax}", S,
        S.set2vec, S.set2vec_reference, args, leaves, cw,
        {"set2vec_fwd": 2, "set2vec_bwd": 1},
        K.width_bucket("", S.BUCKETS, w=w),
        time_steps=steps, batch_softmax=batch_softmax)


CASES = {
    "fused_step": lambda: [
        # the forward kernels on every route: one block, clusters of 2, 4
        # and 8, the grid, the grid with 16-node tiles (spilled); a graph
        # past a block's tile; T 1 and 32
        check_fused_step(20, 9, 10, 14, 6, fwd="cluster 1"),
        check_fused_step(21, 9, 10, 14, 6, "bn1d", "stateless",
                         fwd="cluster 2"),
        check_fused_step(22, 9, 10, 14, 6, "none", "stateless",
                         fwd="cluster 4"),
        check_fused_step(23, 9, 10, 14, 6, fwd="cluster 8"),
        check_fused_step(24, 9, 10, 14, 6, "none", "none", fwd="cluster 8"),
        check_fused_step(25, 9, 10, 14, 6, fwd="grid"),
        check_fused_step(26, 9, 10, 14, 6, "none", "stateless", fwd="grid"),
        check_fused_step(27, 9, 10, 14, 6, "none", "none", fwd="grid"),
        check_fused_step(28, 9, 10, 14, 6, "bn1d", "none", fwd="spilled"),
        check_fused_step(29, 9, 10, 14, 6, "bn1d", "stateless",
                         fwd="spilled"),
        check_fused_step(30, 4, 10, 14, 6, big=40, fwd="cluster 2"),
        check_fused_step(31, 4, 10, 14, 6, "none", "stateless", big=40,
                         fwd="grid"),
        check_fused_step(32, 5, 10, 14, 6, steps=1, fwd="grid"),
        check_fused_step(33, 5, 10, 14, 6, "bn1d", "stateless", steps=32,
                         fwd="cluster 4"),
        check_fused_step(34, 7, 27, 108, 5, "bn1d", "stateless",
                         fwd="cluster 2"),
        check_fused_step(35, 7, 23, 60, 5, "bn1d", "bn1d", fwd="grid"),
        check_fused_step(36, 7, 7, 28, 5, "none", "stateless",
                         fwd="spilled"),
        check_fused_step(0, 9, 10, 14, 6),
        check_fused_step(0, 9, 10, 14, 6, route="one"),
        check_fused_step(0, 9, 10, 14, 6, route="cluster"),
        check_fused_step(0, 9, 10, 14, 6, route="grid"),
        check_fused_step(0, 9, 10, 14, 6, route="spilled"),
        check_fused_step(11, 5, 10, 14, 6, steps=1, route="grid"),
        check_fused_step(12, 5, 10, 14, 64, "bn1d", "stateless", steps=7,
                         route="cluster"),
        check_fused_step(1, 9, 19, 32, 6),
        check_fused_step(2, 7, 32, 64, 5, "none", "bn1d"),
        check_fused_step(2, 7, 32, 64, 5, "none", "bn1d", route="grid"),
        check_fused_step(3, 7, 24, 40, 4, "bn1d", "none"),
        check_fused_step(4, 9, 10, 14, 6, "none", "stateless"),
        check_fused_step(4, 9, 10, 14, 6, "none", "stateless",
                         route="spilled"),
        check_fused_step(5, 9, 7, 28, 6, "none", "none"),
        check_fused_step(5, 9, 7, 28, 6, "none", "none", route="grid"),
        check_fused_step(6, 9, 7, 28, 6, "bn1d", "stateless",
                         route="cluster"),
        check_fused_step(7, 7, 24, 40, 4, "bn1d", "stateless"),
        check_fused_step(8, 7, 27, 108, 5, "none", "none"),
        check_fused_step(9, 7, 27, 108, 5, "none", "stateless",
                         route="grid"),
        check_fused_step(10, 7, 32, 128, 4, "bn1d", "stateless",
                         route="spilled"),
    ],
    "fused_psteps": lambda: [
        check_fused_psteps(0, 9, 8, 16, 5, "bn1d", "bn1d"),
        check_fused_psteps(1, 9, 19, 76, 6, "none", "stateless"),
        check_fused_psteps(2, 7, 32, 128, 5, "bn1d", "bn1d"),
        check_fused_psteps(3, 7, 30, 120, 4, "none", "none", steps=6),
        check_fused_psteps(4, 7, 24, 96, 4, "bn1d", "stateless", steps=2),
    ],
    "fused_att": lambda: [
        check_fused_att(0, 9, 7, 6, True),
        check_fused_att(1, 9, 16, 6, False),
        check_fused_att(2, 7, 32, 5, True),
        check_fused_att(3, 7, 24, 64, False),
    ],
    "fused_att_steps": lambda: [
        check_fused_att_steps(0, 9, 7, 6, 3, False, "stateless"),
        check_fused_att_steps(1, 7, 32, 5, 3, True, "stateless"),
        check_fused_att_steps(2, 7, 24, 5, 1, False, "none", steps=4),
    ],
    "set2vec": lambda: [
        check_set2vec(0, 9, 14, 3, True),
        check_set2vec(1, 9, 32, 3, False),
        check_set2vec(2, 7, 64, 3, True),
        check_set2vec(3, 7, 48, 4, False),
    ],
}


def main(argv) -> int:
    asan = "--asan" in argv
    fams = [a for a in argv if a != "--asan"] or list(CASES)
    specs = [f"{emu.B.library(n, tag)}:{a}" for fam in fams
             for tag in ("", *emu.B.WIDE.get(fam, {}))
             for n, a in ARGS[fam].items()]
    emu.build(specs, asan=asan)
    from mpnn_tpu_torch.kernels import (fused_att, fused_att_steps,
                                        fused_psteps, set2vec)
    emu.emulate(K, fused_psteps, fused_att, fused_att_steps, set2vec)
    oks = [ok for fam in fams for ok in CASES[fam]()]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
