"""Time the decomposed path's recurrence backward (recurrence_bwd), or with
--fwd its forward (recurrence_fwd), of the checkout in the working
directory, so that two commits can be held against each other on one
card:

    cd <checkout> && python <this repo>/scripts/time_recurrence.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its
recurrence kernels and times, with CUDA events over back-to-back launches
(and beside them the device time of a launch in a torch.profiler trace of
20), the backward on the forward's residuals (chip_smoke.py::rec_case's
data: a quarter of the rows masked) at lipo's f 10, T 6 at b16's node
slots, b1024's 16,512 and the split's 57,856 (b3584), and at f 30 (the
f32 build) at 16,512 slots. Each case's data comes from its own seed, the
same in every checkout. Run it on both commits in turns (parent, change,
change, parent).

--detail (a checkout whose chip_smoke.py has _walk_detail) prints each
case's route, empty-walk floor and block 0's clock64 phases. --sweep (a
checkout whose chip_smoke.py has _rec_route) times each case on the
rule's own route and on its neighbours: one cluster of 1, 2, 4 and 8
blocks (while a block's share fits its tile) and the grid at a block per
8, 16, 32, 64 and 128 slots, capped at the card's co-resident blocks,
with lipo at b32-b128's slots added: the measurement behind the rule's
CLUSTER_SLOTS, CLUSTER_NODES and GRID_NODES.

--fwd times the forward instead, training (the stash of pre-norm states
the backward reads) and serving (h_T and the statistics alone), on the
same data at lipo's b16, b128 and b1024 slots, b1024's at f 30 and the
split's 57,856; with --detail (a checkout whose recurrence.py has
device_fwd_shape) each case's route, the empty forward's time (the same
grid and combines, no arithmetic) and block 0's clock64 phases of one
launch; with --sweep (a checkout whose chip_smoke.py has _rec_fwd_route)
the rule's route beside one cluster of 1, 2, 4 and 8 blocks and the grid
at a block per 8 to 128 slots.

Prints one JSON line: {"label", "card", "times": {case: {"ms",
"trace_ms"[, "route", "floor_ms", "phases"]}}, "sweep": {case: [...]}}.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

STEPS = 6
# (name, node slots (negative: a batch of that many of bench.py's
# molecules, its loader's slots), f)
CASES = [
    ("lipo b16 f10", -16, 10),
    ("lipo b1024 f10", 16512, 10),
    ("lipo b3584 f10 (the split's)", 57856, 10),
    ("b1024 f30 (f32)", 16512, 30),
]
# the sweep's extra sizes: lipo's b32, b64 and b128
SWEEP = [("lipo b32 f10", -32, 10), ("lipo b64 f10", -64, 10),
         ("lipo b128 f10", -128, 10)]
# --fwd's cases
FWD_CASES = [
    ("lipo b16 f10", -16, 10),
    ("lipo b128 f10", -128, 10),
    ("lipo b1024 f10", 16512, 10),
    ("b1024 f30 (f32)", 16512, 30),
    ("lipo b3584 f10 (the split's)", 57856, 10),
]


def _case(CS, R, K, i, case, device):
    """The prepared backward launch of a case on the forward's residuals
    and its arguments."""
    _, n, f = case
    if n < 0:
        n = int(CS._batch((CS.SMILES * (-n // len(CS.SMILES) + 1))[:-n],
                          -n)["node_mask"].shape[0])
    gen = torch.Generator().manual_seed(700 + i)
    (msgs, h0, mask, gru, ma, bn), _, g = CS.rec_case(n, f, gen, device)
    with torch.no_grad():
        weights = [t.detach().contiguous() for t in (
            gru["w_ih"], gru["w_hh"], gru["b_ih"], gru["b_hh"],
            ma["weight"], ma["bias"], bn["weight"], bn["bias"])]
        msgs, h0 = msgs.detach(), h0.detach()
        _, stats, htil = K.launch_prepared(R.prepare_recurrence_fwd(
            msgs, h0, mask, weights, steps=STEPS, stash=True))
    args = (msgs, h0, mask, weights, stats, htil, g)
    return R.prepare_recurrence_bwd(*args, steps=STEPS), args


def _time(CS, K, p, reps):
    ms = CS._events_ms(lambda: K.launch_prepared(p), reps)
    trace = CS._kernel_trace_us_n(20, p)[0] / 20 / 1e3
    return {"ms": ms, "trace_ms": trace}


def _shape(R, args, device):
    n, f = args[1].shape
    return R.device_bwd_shape(n, "" if f <= 16 else "f32", STEPS, device)


def _sweep(CS, R, K, args, reps, device):
    """The backward on the rule's route and each forced neighbour
    (chip_smoke.py::_rec_route): '<route tag> <events us> (trace us)'."""
    rule = _shape(R, args, device)
    n, f = args[1].shape
    most = R._lib("recurrence_bwd", "" if f <= 16 else "f32") \
        .mpnn_recurrence_bwd_max_grid(rule.smem_bytes)
    routes = [(None, None)] + [
        (f"cluster {c}", None) for c in (1, 2, 4, 8)
        if -(-n // c) <= rule.ncap] + [
        ("grid", g) for g in sorted({max(2, min(most, -(-n // per)))
                                     for per in (8, 16, 32, 64, 128)})]
    res = []
    for route, grid in routes:
        with CS._rec_route(route, grid):
            p = R.prepare_recurrence_bwd(*args, steps=STEPS)
            shape = _shape(R, args, device)
        t = _time(CS, K, p, reps)
        res.append(f"{'rule ' if route is None else ''}{shape.tag()} "
                   f"{t['ms'] * 1e3:.2f} us (trace "
                   f"{t['trace_ms'] * 1e3:.2f})")
    return [f"{n} slots"] + res


def _fwd_args(CS, i, case, device):
    """A forward case's arguments (msgs, h0, mask, weights)."""
    _, n, f = case
    if n < 0:
        n = int(CS._batch((CS.SMILES * (-n // len(CS.SMILES) + 1))[:-n],
                          -n)["node_mask"].shape[0])
    gen = torch.Generator().manual_seed(900 + i)
    (msgs, h0, mask, gru, ma, bn), _, _ = CS.rec_case(n, f, gen, device)
    weights = [t.detach().contiguous() for t in (
        gru["w_ih"], gru["w_hh"], gru["b_ih"], gru["b_hh"], ma["weight"],
        ma["bias"], bn["weight"], bn["bias"])]
    return msgs.detach(), h0.detach(), mask, weights


def _fwd_phases(p):
    """Block 0's clock64 stamps (cycles) of one forward as phases:
    staging, the message slot's sums and combine, then a step's pass and
    its combine (means over the steps), the first step's combine in four
    parts (the block partial, every block's row there, staged, summed),
    h_T, the route's finish."""
    T = STEPS
    return {"staging": p[1] - p[0], "slot 0": p[3] - p[1],
            "step pass": sum(p[4 + 2 * i] - p[3 + 2 * i]
                             for i in range(T)) / T,
            "step combine": sum(p[5 + 2 * i] - p[4 + 2 * i]
                                for i in range(T)) / T,
            "combine partial": p[76] - p[4], "combine wait": p[77] - p[76],
            "combine stage": p[78] - p[77], "combine sum": p[79] - p[78],
            "h_T": p[70] - p[3 + 2 * T], "finish": p[75] - p[70],
            "total": p[75] - p[0]}


def _fwd_sweep(CS, R, K, fargs, reps, device):
    """The training forward on the rule's route and each forced neighbour
    (chip_smoke.py::_rec_fwd_route): '<route tag> <events us> (trace
    us)'."""
    n, f = fargs[1].shape
    tag = "" if f <= 16 else "f32"
    rule = R.device_fwd_shape(n, tag, STEPS, device)
    most = R._lib("recurrence_fwd", tag).mpnn_recurrence_fwd_max_grid(
        rule.smem_bytes)
    routes = [(None, None)] + [
        (f"cluster {c}", None) for c in (1, 2, 4, 8)
        if -(-n // c) <= rule.ncap] + [
        ("grid", g) for g in sorted({max(2, min(most, 128, -(-n // per)))
                                     for per in (8, 16, 24, 32, 64, 128)})]
    res = []
    for route, grid in routes:
        with CS._rec_fwd_route(route, grid):
            p = R.prepare_recurrence_fwd(*fargs, steps=STEPS, stash=True)
            shape = R.device_fwd_shape(n, tag, STEPS, device)
        t = _time(CS, K, p, reps)
        res.append(f"{'rule ' if route is None else ''}{shape.tag()} "
                   f"{t['ms'] * 1e3:.2f} us (trace "
                   f"{t['trace_ms'] * 1e3:.2f})")
    return [f"{n} slots"] + res


def main_fwd(args, CS, R, K, device, card) -> int:
    wanted = [c for c in args.cases.split(",") if c]
    out, sweep = {}, {}
    for i, case in enumerate(FWD_CASES):
        name = case[0]
        if wanted and not any(name.startswith(c) for c in wanted):
            continue
        fargs = _fwd_args(CS, i, case, device)
        n, f = fargs[1].shape
        line = f"{name} ({n} slots)"
        with torch.no_grad():
            for mode, stash in (("train", True), ("serve", False)):
                p = R.prepare_recurrence_fwd(*fargs, steps=STEPS,
                                             stash=stash)
                out[f"{name} {mode}"] = t = _time(CS, K, p, args.reps)
                line += (f"; {mode} {t['ms'] * 1e3:.2f} us (trace "
                         f"{t['trace_ms'] * 1e3:.2f})")
            if args.detail and hasattr(R, "device_fwd_shape"):
                shape = R.device_fwd_shape(n, "" if f <= 16 else "f32",
                                           STEPS, device)
                fl = R.prepare_recurrence_fwd(*fargs, steps=STEPS,
                                              stash=True, floor=True)
                floor_ms = CS._events_ms(lambda: K.launch_prepared(fl),
                                         args.reps)
                prof = torch.zeros(R.FWD_PROF_SLOTS, dtype=torch.int64,
                                   device=device)
                K.launch_prepared(R.prepare_recurrence_fwd(
                    *fargs, steps=STEPS, stash=True, prof=prof))
                torch.cuda.synchronize()
                phases = {k: round(v) for k, v in
                          _fwd_phases(prof.tolist()).items()}
                out[f"{name} train"].update(route=shape.tag(),
                                            floor_ms=floor_ms,
                                            phases=phases)
                line += (f", route {shape.tag()}, empty-forward floor "
                         f"{floor_ms * 1e3:.2f} us, clock64 cycles "
                         + json.dumps(phases))
            print(line, flush=True)
            if args.sweep and hasattr(CS, "_rec_fwd_route"):
                sweep[name] = _fwd_sweep(CS, R, K, fargs, args.reps, device)
                print(f"sweep {name}: " + "; ".join(sweep[name]),
                      flush=True)
    print(json.dumps({"label": args.label, "card": card, "kernel":
                      "recurrence_fwd", "times": out, "sweep": sweep}),
          flush=True)
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fwd", action="store_true")
    ap.add_argument("--cases", default="",
                    help="comma-separated case-name prefixes (default all)")
    args = ap.parse_args(argv)
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import recurrence as R
    if not torch.cuda.is_available():
        raise SystemExit("time_recurrence: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    if args.fwd:
        return main_fwd(args, CS, R, K, device, card)
    wanted = [c for c in args.cases.split(",") if c]
    out, sweep = {}, {}
    cases = CASES + (SWEEP if args.sweep else [])
    for i, case in enumerate(cases):
        name = case[0]
        if wanted and not any(name.startswith(c) for c in wanted):
            continue
        pb, bargs = _case(CS, R, K, i, case, device)
        line = f"{name} ({bargs[1].shape[0]} slots)"
        if case in CASES:
            out[name] = _time(CS, K, pb, args.reps)
            line += (f": {out[name]['ms'] * 1e3:.2f} us (trace "
                     f"{out[name]['trace_ms'] * 1e3:.2f})")
            if args.detail and hasattr(CS, "_walk_detail"):
                route, floor_ms, phases = CS._walk_detail(
                    lambda **kw: R.prepare_recurrence_bwd(
                        *bargs, steps=STEPS, **kw),
                    lambda: _shape(R, bargs, device),
                    lambda pr: CS._rec_bwd_phases(pr, STEPS),
                    R.launch_counts, device)
                out[name].update(
                    route=route, floor_ms=floor_ms,
                    phases={k: round(v) for k, v in phases.items()})
                line += (f", route {route}, empty-walk floor "
                         f"{floor_ms * 1e3:.2f} us, clock64 cycles "
                         + json.dumps(out[name]["phases"]))
            print(line, flush=True)
        if args.sweep and hasattr(CS, "_rec_route"):
            sweep[name] = _sweep(CS, R, K, bargs, args.reps, device)
            print(f"sweep {name}: " + "; ".join(sweep[name]), flush=True)
    print(json.dumps({"label": args.label, "card": card, "times": out,
                      "sweep": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
