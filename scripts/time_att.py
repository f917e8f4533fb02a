"""Time the adv model's backward kernel (fused_att_bwd, row 15) of the
checkout in the working directory, so that two commits can be held
against each other on one card:

    cd <checkout> && python <this repo>/scripts/time_att.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its
attention kernels and times the backward with CUDA events over
back-to-back launches of its prepared call (and beside them the device
time a launch in a torch.profiler trace of 20), on the training forward's
messages and a random cotangent of: adv's widths (f 7 from bench.py's
molecules, K the batch's vocab, the 'att' correction) at batch 1, 16, 128
and 1024, at b1024 without the correction ('adj'), and the wide bucket
(f 27, random node features) at b16, with random weights from each case's
own seed (chip_smoke.py::_att_case), the same in every checkout. Run it
on both commits in turns (parent, change, change, parent); --cases takes
a subset.

--detail (a checkout whose wrapper takes `prof` and `floor`) prints each
case's launch, the empty walk's time (the same grid and final sum, no
arithmetic; events) and one launch's clock64 phases of block 0. --sweep
(a checkout whose chip_smoke.py has _adv_bwd_route) times each case on the
rule's launch and on SWEEP_ROUTES, ranked on the trace's device time: the
measurement behind the rule's BWD_NODES.

Prints one JSON line: {"label", "card", "times": {case: {"ms",
"trace_ms"}}, "detail": {...}, "sweep": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

CASES = ("adv b1", "adv b16", "adv b128", "adv b1024", "adv b1024 adj",
         "f32 b16")
SWEEP_ROUTES = ("nodes 4", "nodes 8", "nodes 16", "nodes 32", "nodes 64",
                "nodes 128", "one")


def _case(CS, name, device):
    """(weights, h0, msgs, gh, vid, src, dst, plan, with_corr) of a case:
    the training forward's messages and a random cotangent."""
    import torch
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(2000 + CASES.index(name))
    bs = int(name.split()[1][1:])
    tb = batch_to_device(CS._batch((CS.SMILES * (bs // len(CS.SMILES) + 1))
                                   [:bs], bs), device)
    if name.startswith("f32"):
        n = tb["node_feats"].shape[0]
        tb = dict(tb, node_feats=torch.randn(n, 27, generator=gen)
                  .to(device))
    corr = "adj" not in name
    aa = CS._att_case(tb, gen, device)[0]
    with torch.no_grad():
        aprime, a0, qv, q0, wh, h0, mask, ng, gru, vid, src, dst, plan = [
            a.detach() if isinstance(a, torch.Tensor) else a for a in aa]
        gru = {k: v.detach() for k, v in gru.items()}
        weights = list(zip(A._GRAD_LEAVES, (
            aprime, a0, qv, q0, wh, gru["w_ih"], gru["w_hh"], gru["b_ih"],
            gru["b_hh"])))
        h, msgs = K.launch_prepared(A.prepare_fused_att_fwd(
            weights, h0, mask, ng, vid, src, dst, plan, with_corr=corr,
            write_msgs=True))
        gh = torch.randn(h.shape, generator=gen).to(device)
    return weights, h0, msgs, gh, vid, src, dst, plan, corr


def _time(CS, K, p, reps):
    trace = CS._kernel_trace_us_n(20, p)[0] / 20 / 1e3
    return {"ms": CS._events_ms(lambda: K.launch_prepared(p), reps),
            "trace_ms": trace}


def _phases(p):
    """Block 0's clock64 stamps (cycles) as phases: staging and the vocab
    sort, the GRU VJP pass, the GRU weight rows, the message step's parts
    (X_v and the tables staged, the edges, the nodes, the row sums), the
    ∂h0 sums, the final sum."""
    return {"staging": p[1] - p[0], "GRU VJP": p[3] - p[2],
            "GRU rows": p[40] - p[3], "msg tables": p[61] - p[40],
            "msg edges": p[62] - p[61], "msg nodes": p[63] - p[62],
            "msg sums": p[41] - p[63], "dh0": p[60] - p[41],
            "final sum": p[79] - p[60], "total": p[79] - p[0]}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated case names")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_step as K
    if not torch.cuda.is_available():
        raise SystemExit("time_att: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    routed = hasattr(A, "device_bwd_shape")
    out, detail, sweep = {}, {}, {}
    with torch.no_grad():
        for name in CASES:
            if name not in args.cases.split(","):
                continue
            c = _case(CS, name, device)
            *xs, corr = c
            p = A.prepare_fused_att_bwd(*xs, with_corr=corr)
            out[name] = _time(CS, K, p, args.reps)
            print(json.dumps({name: out[name]}), flush=True)
            n, f, k = c[1].shape[0], c[1].shape[1], c[0][0][1].shape[0]
            g = int(c[7].graph_node_ptr.shape[0]) - 1
            tag = K.width_bucket("", A.BUCKETS, f=f, K=k)
            if args.detail and routed:
                shape = A.device_bwd_shape(n, tag, k, g, device)
                fl = A.prepare_fused_att_bwd(*xs, with_corr=corr, floor=True)
                floor = CS._events_ms(lambda: K.launch_prepared(fl),
                                      args.reps)
                prof = torch.zeros(A.PROF_SLOTS, dtype=torch.int64,
                                   device=device)
                K.launch_prepared(A.prepare_fused_att_bwd(
                    *xs, with_corr=corr, prof=prof))
                torch.cuda.synchronize()
                detail[name] = {"route": shape.tag(), "floor_ms": floor,
                                "phases": _phases(prof.tolist())}
                print(json.dumps({name: detail[name]}), flush=True)
            if args.sweep and hasattr(CS, "_adv_bwd_route"):
                row = {}
                for route in (None, *SWEEP_ROUTES):
                    with CS._adv_bwd_route(route):
                        stag = A.device_bwd_shape(n, tag, k, g,
                                                  device).tag()
                        pr = A.prepare_fused_att_bwd(*xs, with_corr=corr)
                    row[f"{route or 'rule'} ({stag})"] = _time(CS, K, pr,
                                                               args.reps)
                row["ranked on trace"] = sorted(
                    (r for r in row), key=lambda r: row[r]["trace_ms"])
                sweep[name] = row
                print(json.dumps({f"sweep {name}": row}), flush=True)
    print(json.dumps({"label": args.label, "card": card,
                      "kernel": "fused_att_bwd", "times": out,
                      "detail": detail, "sweep": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
