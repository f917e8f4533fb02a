"""Time the attention SDDMM kernels (sddmm_fwd, sddmm_bwd) of the checkout
in the working directory, so that two commits can be held against each
other on one card:

    cd <checkout> && python <this repo>/scripts/time_sddmm.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its SDDMM
kernels and times each, with CUDA events over back-to-back launches of
its prepared call (and beside them the device time a launch in a
torch.profiler trace of 20), at: adv's first message network at batch 16
and 1024 of bench.py's molecules (K 8, f 7, ef 6: the main path's
inputs, as chip_smoke.py::_sddmm_inputs gives them); and on the b1024
batch in 16,512 node slots with random weights at f 27 with 64 vocab ids,
f 32 with ef 32 and 64 ids (the wide bucket), mf 13 at nf 10, and at
32,896 node slots (2,560 molecules, f 7), as chip_smoke.py::_sddmm_case
makes them. Each case's data comes from its own seed, the same in every
checkout. Run it on both commits in turns (parent, change, change,
parent); --cases takes a subset.

--detail (a checkout whose chip_smoke.py has _sddmm_detail) prints each
case's routes, empty-kernel floors and one launch's clock64 phases.
--sweep (a checkout whose chip_smoke.py has _sddmm_route) times each
kernel at each of SWEEP_TILES (positions a lane group takes in a tile,
and in the backward's vocab tiles) on adv's kernels at batch 16 to 1024
and on the f 27 K 64, mf 13 nf 10 and 32,896-slot cases, and ranks them,
for each kernel, on the device time a launch in a trace (the events
hold the host's launch path between back-to-back launches), beside the
tiles of the rule: the measurement behind kernels/sddmm.py's
GRID_WAVE and TILE_PER. Each case is swept `--sweep-passes` times in
turns.

Prints one JSON line: {"label", "card", "times": {case: {kernel: {"ms",
"trace_ms"}}}, "sweep": {...}}.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

CASES = ("adv b16", "adv b1024", "f27 K64", "f32 ef32 K64", "mf13 nf10",
         "32896 slots")


def _adv_inputs(CS, bs, gen, device):
    """adv's first message network's SDDMM inputs on a batch of bench.py's
    molecules, and a random cotangent."""
    import torch
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.trainer import batch_to_device
    b = CS._batch((CS.SMILES * (bs // len(CS.SMILES) + 1))[:bs], bs)
    tb = batch_to_device(b, device)
    cfg = zoo.build("adv", afm=b["node_feats"].shape[1],
                    bfm=b["edge_feats"].shape[1], n_out=CS.PS_CLASSES)
    net = network_init(cfg, gen, device)
    args, plan = CS._sddmm_inputs(net, tb)
    g = torch.randn(args[4].shape[0], args[0].shape[1],
                    generator=gen).to(device)
    return (*args, plan, g)


def _case(CS, name, device):
    """(aprime, evocab, wa, ba, h, vid, src, dst, plan, gout) of a case."""
    import torch
    gen = torch.Generator().manual_seed(1500 + CASES.index(name))
    if name.startswith("adv"):
        return _adv_inputs(CS, int(name.split("b")[-1]), gen, device)
    b1024, _, big, _ = CS._dec_check_batches(device)
    if name == "f27 K64":
        return CS._sddmm_case(b1024, 27, 64, gen, device)
    if name == "f32 ef32 K64":
        return CS._sddmm_case(b1024, 32, 64, gen, device, ef=32)
    if name == "mf13 nf10":
        return CS._sddmm_case(b1024, 10, 9, gen, device, mf=13)
    return CS._sddmm_case(big, 7, None, gen, device)


def _prepare(D, c):
    """The checkout's prepared forward and backward on case c (the
    parent's wrappers take the destination order in the backward and no
    dst in the forward; the change's the other way round)."""
    aprime, evocab, wa, ba, h, vid, src, dst, plan, g = c
    order, ptr = plan.edge_order, plan.dst_ptr
    if "dst" in inspect.signature(D.prepare_sddmm_fwd).parameters:
        return (D.prepare_sddmm_fwd(aprime, evocab, wa, ba, h, vid, src, dst,
                                    order, ptr),
                D.prepare_sddmm_bwd(aprime, evocab, wa, ba, h, g, vid, src,
                                    dst))
    return (D.prepare_sddmm_fwd(aprime, evocab, wa, ba, h, vid, src, order,
                                ptr),
            D.prepare_sddmm_bwd(aprime, evocab, wa, ba, h, g, vid, src, dst,
                                order, ptr))


def _time(CS, K, pf, pb, reps, n_trace=20):
    trace = CS._kernel_trace_us_n(n_trace, pf, pb)
    return {p.name: {"ms": CS._events_ms(lambda p=p: K.launch_prepared(p),
                                         reps),
                     "trace_ms": t / n_trace / 1e3}
            for p, t in zip((pf, pb), trace)}


# the forced tiles of --sweep: (positions a group, in a vocab tile)
SWEEP_TILES = {"sddmm_fwd": [(1, 1), (2, 1), (3, 1), (4, 1), (8, 1)],
               "sddmm_bwd": [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4),
                             (8, 4), (8, 8)]}
SWEEP_CASES = ("adv b16", "adv b128", "adv b256", "adv b1024",
               "32896 slots", "f27 K64", "mf13 nf10")


def _sweep(CS, D, K, device, reps, passes):
    """Each kernel on each SWEEP_CASES case at the rule's tiles and at each
    of SWEEP_TILES, `passes` times in turns: events (`ms`) and a trace's
    device time a launch (`trace_ms`, 50 launches a trace), one value a
    pass; then the tiles ranked on their slowest pass's trace time."""
    import torch
    out = {}
    for name in SWEEP_CASES:
        if name.startswith("adv"):
            bs = int(name.split("b")[-1])
            c = _adv_inputs(CS, bs, torch.Generator().manual_seed(1600 + bs),
                            device)
        else:
            c = _case(CS, name, device)
        e, (k, mf, nf) = c[5].shape[0], c[0].shape
        row = {}
        for _ in range(passes):
            for i, kernel in enumerate(("sddmm_fwd", "sddmm_bwd")):
                for per in [None, *SWEEP_TILES[kernel]]:
                    with CS._sddmm_route(per=per):
                        tag = D.device_shape(kernel[-3:], e, mf, nf, k,
                                             device).tag()
                        p = _prepare(D, c)[i]
                        tr = CS._kernel_trace_us_n(50, p)[0] / 50 / 1e3
                        ms = CS._events_ms(lambda: K.launch_prepared(p),
                                           reps)
                    r = row.setdefault(kernel, {}).setdefault(
                        tag, {"ms": [], "trace_ms": []})
                    r["ms"].append(ms)
                    r["trace_ms"].append(tr)
                    if per is None:
                        row.setdefault("rule", {})[kernel] = tag
        row["ranked on trace"] = {
            kernel: sorted(row[kernel],
                           key=lambda t: max(row[kernel][t]["trace_ms"]))
            for kernel in ("sddmm_fwd", "sddmm_bwd")}
        out[f"{name} ({e} edges)"] = row
        print(json.dumps({f"sweep {name}": row}), flush=True)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-passes", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated case names")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import sddmm as D
    if not torch.cuda.is_available():
        raise SystemExit("time_sddmm: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    out = {}
    with torch.no_grad():
        for name in CASES:
            if name not in args.cases.split(","):
                continue
            c = _case(CS, name, device)
            pf, pb = _prepare(D, c)
            out[name] = _time(CS, K, pf, pb, args.reps)
            if args.detail and hasattr(CS, "_sddmm_detail"):
                rebuild = lambda i, **kw: _prepare_kw(D, c, i, **kw)
                floors, phases = CS._sddmm_detail(
                    pf, pb, lambda **kw: rebuild(0, **kw),
                    lambda **kw: rebuild(1, **kw), device)
                e = c[5].shape[0]
                tags = [D.device_shape(d, e, c[0].shape[1], c[0].shape[2],
                                       c[0].shape[0], device).tag()
                        for d in ("fwd", "bwd")]
                print(json.dumps({name: {"routes": tags, "floor_ms": floors,
                                         "phases": phases}}), flush=True)
        sweep = (_sweep(CS, D, K, device, args.reps, args.sweep_passes)
                 if args.sweep and hasattr(CS, "_sddmm_route") else None)
    print(json.dumps({"label": args.label, "card": card, "times": out,
                      "sweep": sweep}), flush=True)
    return 0


def _prepare_kw(D, c, i, **kw):
    """The change's prepared forward (i 0) or backward (i 1) with the
    wrappers' measurement options (prof, floor)."""
    aprime, evocab, wa, ba, h, vid, src, dst, plan, g = c
    if i == 0:
        return D.prepare_sddmm_fwd(aprime, evocab, wa, ba, h, vid, src, dst,
                                   plan.edge_order, plan.dst_ptr, **kw)
    return D.prepare_sddmm_bwd(aprime, evocab, wa, ba, h, g, vid, src, dst,
                               **kw)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
