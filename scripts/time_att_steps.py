"""Time the att model's T-step backward kernel (fused_att_steps_bwd, row
16) of the checkout in the working directory, so that two commits can be
held against each other on one card:

    cd <checkout> && python <this repo>/scripts/time_att_steps.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its att-steps
kernels and times the backward with CUDA events over back-to-back launches
of its prepared call (and beside them the device time a launch in a
torch.profiler trace of 20), on the training forward's residuals of: the
att model's widths (f 7 from bench.py's molecules, T 3, K the batch's
vocab, the stateless norm and the 'att' correction) at batch 16, 128 and
1024 with per-step tables (Tm 3), at b1024 with one shared table (Tm 1)
and without a state norm, at batch 40, 4 and 1 (a request of one
molecule), and the wide bucket (f 27, random node features) at b16, with
random weights from each case's own seed (chip_smoke.py::_atts_case), the
same in every checkout. Run it on both commits in turns (parent, change,
change, parent); --cases takes a subset.

--fwd times the training forward (fused_att_steps_fwd, the residuals'
launch) of the same cases instead.

--detail (a checkout whose wrapper takes `prof` and `floor`) prints each
case's route, the empty walk's time (the same grid and combines, no
arithmetic; events) and one launch's clock64 phases of block 0. --sweep
(a checkout whose chip_smoke.py has _att_bwd_route) times each case on
the rule's route and on SWEEP_ROUTES, ranked on the trace's device time:
the measurement behind the walk policy's constants for this kernel.

Prints one JSON line: {"label", "card", "times": {case: {"ms",
"trace_ms"}}, "detail": {...}, "sweep": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

CASES = ("att b16", "att b128", "att b1024", "att b1024 Tm1",
         "att b1024 none", "att b40", "f32 b16", "att b1", "att b4")
SWEEP_ROUTES = ("cluster 1", "cluster 2", "cluster 4", "cluster 8",
                "grid 2", "grid 4", "grid 8", "grid 16", "grid 33",
                "grid 66", "grid 99", "grid 132")


def _case(CS, name, device, fwd=False):
    """(weights, h0, msgs, htil, stats, gh, vid, src, dst, plan, meta) of
    a case: the training forward's residuals and a random cotangent; with
    `fwd` the training forward's prepared launch instead."""
    import torch
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(1900 + CASES.index(name))
    bs = int(name.split()[1][1:])
    tb = batch_to_device(CS._batch((CS.SMILES * (bs // len(CS.SMILES) + 1))
                                   [:bs], bs), device)
    if name.startswith("f32"):
        n = tb["node_feats"].shape[0]
        tb = dict(tb, node_feats=torch.randn(n, 27, generator=gen)
                  .to(device))
    tm = 1 if "Tm1" in name else 3
    norm = "none" if "none" in name else "stateless"
    args, _ = CS._atts_case(tb, gen, device, tm)
    with torch.no_grad():
        aprime, a0, qv, q0, wh, h0, mask, ng, gru, vid, src, dst, plan = [
            a.detach() if isinstance(a, torch.Tensor) else a for a in args]
        gru = {k: v.detach() for k, v in gru.items()}
        weights = list(zip(AS._GRAD_LEAVES, (
            aprime, a0, qv, q0, wh, gru["w_ih"], gru["w_hh"], gru["b_ih"],
            gru["b_hh"])))
        meta = AS.AttsMeta(3, True, norm == "stateless")
        pf = AS.prepare_fused_att_steps_fwd(weights, h0, mask, ng, vid, src,
                                            dst, plan, meta, train=True)
        if fwd:
            return pf
        h, msgs, htil, stats = K.launch_prepared(pf)
        gh = torch.randn(h.shape, generator=gen).to(device)
    return weights, h0, msgs, htil, stats, gh, vid, src, dst, plan, meta


def _time(CS, K, p, reps):
    trace = CS._kernel_trace_us_n(20, p)[0] / 20 / 1e3
    return {"ms": CS._events_ms(lambda: K.launch_prepared(p), reps),
            "trace_ms": trace}


def _phases(p, T):
    """Block 0's clock64 stamps (cycles) as phases: staging and the vocab
    sort, the first slot's sums, then per step its combine and its pass,
    the GRU rows, the message VJP of each step, the ∂h0 sums, the final
    sum."""
    steps = [(p[3 + 2 * i] - p[2 + 2 * i]) for i in range(T)]
    combines = [p[2] - p[1]] + [p[2 + 2 * i] - p[1 + 2 * i]
                                for i in range(1, T)]
    msg = [p[41 + t] - (p[40] if t == 0 else p[40 + t]) for t in range(T)
           if p[41 + t]]
    out = {"staging": p[1] - p[0], "step combine": sum(combines) / T,
           "step": sum(steps) / T, "GRU rows": p[40] - p[1 + 2 * T],
           "message step": sum(msg) / max(len(msg), 1),
           "dh0": p[60] - p[40 + len(msg)], "final sum": p[79] - p[60],
           "total": p[79] - p[0]}
    # a checkout that stamps the message step's parts (slots 61 + 3t..):
    # the tables staged (after X_v at t = 0), the edges, the nodes, the
    # row sums
    if p[61]:
        n = len(msg)
        part = lambda a, b: sum(p[b + 3 * t] - (p[a + 3 * t] if a else (
            p[40] if t == 0 else p[40 + t])) for t in range(n)) / n
        out.update({"msg tables": part(0, 61), "msg edges": part(61, 62),
                    "msg nodes": part(62, 63),
                    "msg sums": sum(p[41 + t] - p[63 + 3 * t]
                                    for t in range(n)) / n})
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fwd", action="store_true")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated case names")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import fused_step as K
    if not torch.cuda.is_available():
        raise SystemExit("time_att_steps: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    routed = hasattr(AS, "device_bwd_shape")
    out, detail, sweep = {}, {}, {}
    with torch.no_grad():
        for name in CASES:
            if name not in args.cases.split(","):
                continue
            if args.fwd:
                out[name] = _time(CS, K, _case(CS, name, device, fwd=True),
                                  args.reps)
                print(json.dumps({name: out[name]}), flush=True)
                continue
            c = _case(CS, name, device)
            p = AS.prepare_fused_att_steps_bwd(*c)
            out[name] = _time(CS, K, p, args.reps)
            print(json.dumps({name: out[name]}), flush=True)
            n, k = c[1].shape[0], c[0][0][1].shape[1]
            tm, T = c[0][0][1].shape[0], c[-1].steps
            if args.detail and routed:
                tag = K.width_bucket("", AS.BUCKETS, f=c[1].shape[1], K=k,
                                     steps=T)
                shape = AS.device_bwd_shape(n, tag, tm, k, T,
                                            c[-1].stateless, device)
                fl = AS.prepare_fused_att_steps_bwd(*c, floor=True)
                floor = CS._events_ms(lambda: K.launch_prepared(fl), 100)
                prof = torch.zeros(AS.PROF_SLOTS, dtype=torch.int64,
                                   device=device)
                K.launch_prepared(AS.prepare_fused_att_steps_bwd(*c,
                                                                 prof=prof))
                torch.cuda.synchronize()
                detail[name] = {"route": shape.tag(), "floor_ms": floor,
                                "phases": _phases(prof.tolist(), T)}
                print(json.dumps({name: detail[name]}), flush=True)
            if args.sweep and hasattr(CS, "_att_bwd_route"):
                row = {}
                for route in (None, *SWEEP_ROUTES):
                    with CS._att_bwd_route(route):
                        tag = AS.device_bwd_shape(
                            n, K.width_bucket("", AS.BUCKETS,
                                              f=c[1].shape[1], K=k, steps=T),
                            tm, k, T, c[-1].stateless, device).tag()
                        pr = AS.prepare_fused_att_steps_bwd(*c)
                    row[f"{route or 'rule'} ({tag})"] = _time(CS, K, pr,
                                                              args.reps)
                row["ranked on trace"] = sorted(
                    (r for r in row), key=lambda r: row[r]["trace_ms"])
                sweep[name] = row
                print(json.dumps({f"sweep {name}": row}), flush=True)
    print(json.dumps({"label": args.label, "card": card, "times": out,
                      "detail": detail, "sweep": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
