"""The split training backward's kernels (csrc/ro_bwd.cu, csrc/msg_bwd.cu,
csrc/ps_walk_bwd.cu, with csrc/recurrence_bwd.cu between them for the
shared family) run on the CPU through the CUDA stand-in. Each kernel
through its wrapper against its plain version (chip_smoke.py::
split_kernel_case: inputs random at the padded node slots), in the narrow
and the wide bucket, every per-step norm pair, T 1 and 3; then both
families' ops with bwd="split" (the forward's plain version, the
emulated backward kernels) against the plain whole-step version under
autograd, the shared family's recurrence_bwd on every route its rule
can take (chip_smoke.py::_rec_route, the tile overflow and a cluster of
one among them), and the per-step family's whole backward
(fused_psteps_bwd) on every route of its rule (chip_smoke.py::_ps_route)
beside its split. A rehearsal before a chip call; timings mean nothing
here. Run from the repository root:

    python scripts/cuda_emu/check_split_bwd.py [--asan]

which builds the eleven libraries first. Exits non-zero when a case
disagrees beyond 1e-4 / 1e-5 (each output divided by its max abs).
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(os.path.dirname(HERE)),
                                   "tests")]

import emu                                                     # noqa: E402
import chip_smoke as C                                         # noqa: E402
from mpnn_tpu_torch.kernels import fused_psteps as P           # noqa: E402
from mpnn_tpu_torch.kernels import fused_step as K             # noqa: E402
from mpnn_tpu_torch.kernels import msg_bwd as MB               # noqa: E402
from mpnn_tpu_torch.kernels import psteps_walk as PW           # noqa: E402
from mpnn_tpu_torch.kernels import readout_bwd as RB           # noqa: E402
from mpnn_tpu_torch.kernels import recurrence as R             # noqa: E402

CPU = torch.device("cpu")


def batches():
    """A ragged batch of 40 molecules with padded slots, and the ragged
    batch of single atoms and a padded graph slot."""
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import attach_fused_plan
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gs, _ = G.encode_molgraphs(G.generate_molgraphs(
        (C.SMILES * 4)[:40], [0.0] * 40))
    b40 = batch_to_device(attach_fused_plan(G.attach_edge_vocab(
        G.collate_packed(gs, node_cap=640).as_dict(), vocab_cap=8)), CPU)
    return b40, C._ragged_att_batch(CPU)


def kernel_cases(b40, ragged):
    gen = torch.Generator().manual_seed(5)
    cases = ([(b40, 8, 16, 3, mn, sn, None) for mn, sn in C.PS_NORMS]
             + [(b40, 10, 14, 1, "bn1d", "bn1d", None),
                (ragged, 7, 28, 2, "none", "stateless", None),
                (b40, 27, 108, 3, "bn1d", "bn1d", 24),
                (b40, 32, 128, 2, "none", "stateless", 24),
                (ragged, 30, 60, 1, "bn1d", "bn1d", 20)])
    ok_all = True
    for tb, f, od, T, mn, sn, k in cases:
        res = C.split_kernel_case(tb, f, od, T, mn, sn, gen, CPU, k=k)
        ok = all(o for o, _ in res.values())
        ok_all = ok_all and ok
        print(f"N={tb['node_mask'].shape[0]} f={f} od={od} T={T} {mn}/{sn}"
              + (f" K={k}" if k else "") + ": " + " ".join(
                  f"{n} {e:.2e}" for n, (_, e) in res.items())
              + f" {'ok' if ok else 'FAIL'}", flush=True)
    return ok_all


def route_cases(b40):
    """fused_step and fused_psteps with bwd='split' against the plain
    whole-step version under autograd, recurrence_bwd on every forced
    route; fused_psteps with bwd='whole' on every forced route of its
    backward."""
    gen = torch.Generator().manual_seed(6)
    ok_all = True
    f = int(b40["node_feats"].shape[1] + b40["node_nafm"].shape[1])
    k = int(b40["edge_vfirst"].shape[0])
    w = C._random_weights(f, 14, k, gen, CPU)
    args, leaves = C._step_args(b40, w, gen)
    cw = torch.randn(args[10].shape[0], 14, generator=gen)
    kw = dict(steps=4, msg_norm="bn1d", state_norm="bn1d")
    want = C._step_and_grads(K.fused_step_reference, args, leaves, cw, kw)
    for route in (None, *C.REC_ROUTES):
        for mod in (K, MB, RB, R):
            mod.reset_launch_counts()
        with C._rec_route(route, 3 if route == "grid" else None):
            got = C._step_and_grads(K.fused_step, args, leaves, cw,
                                    dict(kw, bwd="split"))
            shape = R.device_bwd_shape(args[3].shape[0], "", 4, CPU)
        counts = {**RB.launch_counts, **MB.launch_counts,
                  "recurrence_bwd": R.launch_counts["recurrence_bwd"]}
        ok_f, err_f, ok_b, err_b = C._step_errors(got, want, "bn1d")
        ok = ok_f and ok_b and counts == {"ro_bwd": 1, "msg_bwd": 1,
                                          "recurrence_bwd": 1}
        ok_all = ok_all and ok
        print(f"fused_step bwd=split f={f} recurrence_bwd {shape.tag()}: "
              f"fwd {err_f:.2e} bwd {err_b:.2e} launches {counts} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    c, leaves = C._ps_case(b40, 8, 16, gen, CPU)
    cw = torch.randn(c["labels"].shape[0], 16, generator=gen)
    kw = dict(steps=3, msg_norm="bn1d", state_norm="bn1d")
    want = C._step_and_grads(P.fused_psteps_reference, C._ps_step_args(c),
                             leaves, cw, kw)
    for route in (None, *C.PS_ROUTES):
        P.reset_launch_counts()
        with C._ps_route(route, 3 if route == "grid" else None):
            got = C._step_and_grads(P.fused_psteps, C._ps_step_args(c),
                                    leaves, cw, dict(kw, bwd="whole"))
            shape = P.device_bwd_shape(c["h0"].shape[0], "", k, 3, True,
                                       CPU)
        ok_f, err_f, ok_b, err_b = C._step_errors(got, want, "bn1d")
        ok = ok_f and ok_b and P.launch_counts["fused_psteps_bwd"] == 1
        ok_all = ok_all and ok
        print(f"fused_psteps bwd=whole {shape.tag()}: fwd {err_f:.2e} bwd "
              f"{err_b:.2e} {'ok' if ok else 'FAIL'}", flush=True)
    for mn, sn in C.PS_NORMS:
        c, leaves = C._ps_case(b40, 8, 16, gen, CPU)
        cw = torch.randn(c["labels"].shape[0], 16, generator=gen)
        kw = dict(steps=3, msg_norm=mn, state_norm=sn)
        for mod in (MB, RB, PW):
            mod.reset_launch_counts()
        got = C._step_and_grads(P.fused_psteps, C._ps_step_args(c), leaves,
                                cw, dict(kw, bwd="split"))
        counts = {**RB.launch_counts, **MB.launch_counts,
                  **PW.launch_counts}
        want = C._step_and_grads(P.fused_psteps_reference,
                                 C._ps_step_args(c), leaves, cw, kw)
        ok_f, err_f, ok_b, err_b = C._step_errors(got, want, mn)
        ok = ok_f and ok_b and counts == dict.fromkeys(C.SPLIT_KERNELS, 1)
        ok_all = ok_all and ok
        print(f"fused_psteps bwd=split {mn}/{sn}: fwd {err_f:.2e} bwd "
              f"{err_b:.2e} launches {counts} {'ok' if ok else 'FAIL'}",
              flush=True)
    return ok_all


def main(argv) -> int:
    emu.build(["ro_bwd:RoArgs", "msg_bwd:MsgArgs", "ps_walk_bwd:WalkArgs",
               "recurrence_bwd:BwdArgs", "ro_bwd.f32:RoArgs",
               "msg_bwd.f32:MsgArgs", "ps_walk_bwd.f32:WalkArgs",
               "recurrence_bwd.f32:BwdArgs", "fused_step_fwd:FwdArgs",
               "fused_psteps_fwd:PsFwdArgs", "fused_psteps_bwd:PsBwdArgs"],
              asan="--asan" in argv)
    emu.emulate(RB, MB, PW, R, K, P)
    b40, ragged = batches()
    oks = [kernel_cases(b40, ragged), route_cases(b40)]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
