"""Time the vocab SpMM forward kernel (spmm_fwd: the message sum and its
transposed launch, the VJP's dh) of the checkout in the working
directory, so that two commits can be held against each other on one
card:

    cd <checkout> && python <this repo>/scripts/time_spmm.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its SpMM
kernels and times each launch, with CUDA events over back-to-back
launches of its prepared call (and beside them the device time a launch
in a torch.profiler trace of 20), at lipo's widths (f 10) on bench.py's
molecules at batch 16 and 1024 (16,512 node slots) with the batch's own
vocab (K 8), at K 64 (f 10, the narrow bucket), at f 30 with K 8 and 64
(the wide bucket), and at 32,896 node slots (2,560 molecules, f 10), as
chip_smoke.py::_spmm_case makes them (random h and A). Each case times
the forward (the destination order) and dh (Aᵀ through the source
order). Each case's data comes from its own seed, the same in every
checkout. Run it on both commits in turns (parent, change, change,
parent); --cases takes a subset.

--detail (a checkout whose chip_smoke.py has _spmm_detail) prints each
launch's tiles, empty-kernel floor and one launch's clock64 phases.
--sweep (a checkout whose chip_smoke.py has _spmm_route) times each
launch at each of SWEEP_PER (positions a lane group takes in a tile)
beside the rule's tiles, `--sweep-passes` times in turns, and ranks them
on the device time a launch in a trace: the measurement behind
kernels/spmm.py's GRID_WAVE and TILE_POSITIONS.

Prints one JSON line: {"label", "card", "times": {case: {"fwd": {"ms",
"trace_ms"}, "dh": {...}}}, "sweep": {...}}.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

# (name, batch: 16, 1024 or 2560, f, K (None: the batch's own))
CASES = (("lipo b16", 16, 10, None), ("lipo b1024", 1024, 10, None),
         ("b1024 K64", 1024, 10, 64), ("f30 b1024 K8", 1024, 30, 8),
         ("f30 b1024 K64", 1024, 30, 64), ("32896 slots", 2560, 10, None))
SWEEP_PER = (1, 2, 3, 4, 6, 8)


def _case(CS, i, device):
    """(a, h, vid, src, dst, plan, g) of case i, and the source order."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    _, bs, f, k = CASES[i]
    gen = torch.Generator().manual_seed(1700 + i)
    b1024, b16, big, _ = CS._dec_check_batches(device)
    tb = {16: b16, 1024: b1024, 2560: big}[bs]
    c = CS._spmm_case(tb, f, k, gen, device)
    return c, K.source_order(c[3], c[1].shape[0])


def _prepare(S, c, so, **kw):
    """The checkout's prepared forward and dh launches on case c (the
    parent's wrapper takes no output-row array)."""
    a, h, vid, src, dst, plan, g = c
    n = h.shape[0]
    at = a.transpose(1, 2).contiguous()
    if "key" in inspect.signature(S.prepare_spmm_fwd).parameters:
        return (S.prepare_spmm_fwd(a, h, vid, src, dst, plan.edge_order,
                                   plan.dst_ptr, n_out=n, **kw),
                S.prepare_spmm_fwd(at, g, vid, dst, src, *so, n_out=n,
                                   **kw))
    return (S.prepare_spmm_fwd(a, h, vid, src, plan.edge_order, plan.dst_ptr,
                               n_out=n),
            S.prepare_spmm_fwd(at, g, vid, dst, *so, n_out=n))


def _time(CS, K, p, reps):
    return {"ms": CS._events_ms(lambda: K.launch_prepared(p), reps),
            "trace_ms": CS._kernel_trace_us_n(20, p)[0] / 20 / 1e3}


def _sweep(CS, S, K, c, so, device, reps, passes):
    """Both launches at the rule's tiles and each forced SWEEP_PER,
    `passes` times in turns, ranked on the slowest pass's trace time."""
    row = {}
    e, (k, mo, ni) = c[2].shape[0], c[0].shape
    for _ in range(passes):
        for per in (None, *SWEEP_PER):
            with CS._spmm_route(per=per):
                tag = S.device_shape(e, mo, ni, k, device).tag()
                for what, p in zip(("fwd", "dh"), _prepare(S, c, so)):
                    t = _time(CS, K, p, reps)
                    r = row.setdefault(what, {}).setdefault(
                        tag, {"ms": [], "trace_ms": []})
                    r["ms"].append(t["ms"])
                    r["trace_ms"].append(t["trace_ms"])
            if per is None:
                row["rule"] = tag
    row["ranked on trace"] = {
        what: sorted(row[what], key=lambda t: max(row[what][t]["trace_ms"]))
        for what in ("fwd", "dh")}
    return row


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-passes", type=int, default=2)
    ap.add_argument("--cases", default="",
                    help="comma-separated case-name prefixes (default all)")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import spmm as S
    if not torch.cuda.is_available():
        raise SystemExit("time_spmm: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    wanted = [w for w in args.cases.split(",") if w]
    out, sweep = {}, {}
    with torch.no_grad():
        for i, (name, *_) in enumerate(CASES):
            if wanted and not any(name.startswith(w) for w in wanted):
                continue
            c, so = _case(CS, i, device)
            pf, pd = _prepare(S, c, so)
            out[name] = {"fwd": _time(CS, K, pf, args.reps),
                         "dh": _time(CS, K, pd, args.reps)}
            line = {name: out[name]}
            if args.detail and hasattr(CS, "_spmm_detail"):
                line["detail"] = {
                    what: CS._spmm_detail(
                        lambda j=j, **kw: _prepare(S, c, so, **kw)[j],
                        device)
                    for j, what in enumerate(("fwd", "dh"))}
            print(json.dumps(line), flush=True)
            if args.sweep and hasattr(CS, "_spmm_route"):
                sweep[name] = _sweep(CS, S, K, c, so, device, args.reps,
                                     args.sweep_passes)
                print(json.dumps({f"sweep {name}": sweep[name]}),
                      flush=True)
    print(json.dumps({"label": args.label, "card": card, "times": out,
                      "sweep": sweep or None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
