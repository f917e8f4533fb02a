"""Time the per-step family's whole-step training backward
(fused_psteps_bwd), or with --fwd its training forward (fused_psteps_fwd),
of the checkout in the working directory, so that two commits can be held
against each other on one card:

    cd <checkout> && python <this repo>/scripts/time_fused_psteps.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its
per-step kernels and times, with CUDA events over back-to-back launches
(and beside them the device time of a launch in a torch.profiler trace of
20), the backward on the training forward's residuals at: encoded's
widths (f 8, od 16, T 3, the batch's vocab) at batch 16, 128 and 1024 of
bench.py's molecules, bn1d/bn1d; graph_norm's (f = afm, od = 4·afm, T 3)
none/stateless at b128 and b1024; the wide phase's b16 at afm 27 (the f32
build, none/stateless); 28,672 node slots of bench.py's molecules (the
split's boundary; bn1d/bn1d, the whole backward); and encoded_ecfp's
widths (f 8, od 32, T 3) bn1d/none, the one main-path model without a
state norm, at b16, b128 and b1024 of bench.py's molecules. Each case's data
comes from its own seed, the same in every checkout. Run it on both
commits in turns (parent, change, change, parent).

--detail (a checkout whose chip_smoke.py has _walk_detail) prints each
case's route, empty-walk floor and block 0's clock64 phases. --sweep (a
checkout whose chip_smoke.py has _ps_route) times the encoded, encoded_ecfp
and graph_norm cases on the rule's own route and on its neighbours: one cluster
of 1, 2, 4 and 8 blocks (while a block's share fits its tile) and the
grid at a block per 8, 16, 32, 64 and 128 slots, capped at the card's
co-resident blocks: the measurement behind the rule's CLUSTER_SLOTS and
GRID_NODES.

--fwd times the training forward (fused_psteps_fwd) instead, on the same
cases and inputs: --detail then prints its route, empty-forward floor and
clock64 phases (a checkout whose chip_smoke.py has _ps_fwd_detail), and
--sweep (one with _ps_fwd_route) its rule's route beside one cluster of
1, 2, 4 and 8 blocks and the grid at a block per 8, 16, 24, 32, 64 and 128
slots: the measurement behind fused_step.fwd_policy's constants for this
kernel.

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

# (name, batch (negative: the wide phase's SMILES), node slots (None: the
# loader's), from the node features (graph_norm), msg norm, state norm,
# od (None: 4·afm from the features, else encoded's 16))
CASES = [
    ("encoded b16 bn1d/bn1d", 16, None, False, "bn1d", "bn1d"),
    ("encoded b128 bn1d/bn1d", 128, None, False, "bn1d", "bn1d"),
    ("encoded b1024 bn1d/bn1d", 1024, None, False, "bn1d", "bn1d"),
    ("graph_norm b128 none/stateless", 128, None, True, "none",
     "stateless"),
    ("graph_norm b1024 none/stateless", 1024, None, True, "none",
     "stateless"),
    ("wide graph_norm b16 none/stateless (f32)", -16, None, True, "none",
     "stateless"),
    ("encoded 28,672 slots bn1d/bn1d", 1776, 28672, False, "bn1d", "bn1d"),
    ("encoded_ecfp b16 bn1d/none", 16, None, False, "bn1d", "none", 32),
    ("encoded_ecfp b128 bn1d/none", 128, None, False, "bn1d", "none", 32),
    ("encoded_ecfp b1024 bn1d/none", 1024, None, False, "bn1d", "none", 32),
]


def _batch(CS, bs, slots, device):
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import attach_fused_plan
    from mpnn_tpu_torch.train.trainer import batch_to_device
    smiles = CS.WIDE_SMILES if bs < 0 else CS.SMILES
    n = abs(bs)
    rows = (smiles * (n // len(smiles) + 1))[:n]
    if slots is None:
        return batch_to_device(CS._batch(rows, n), device)
    gs, _ = G.encode_molgraphs(G.generate_molgraphs(rows, [0.0] * n))
    return batch_to_device(attach_fused_plan(G.attach_edge_vocab(
        G.collate_packed(gs, node_cap=slots).as_dict(), vocab_cap=8)),
        device)


def _case(CS, P, K, i, case, device, fwd=False):
    """The prepared backward launch of a case on the forward's residuals,
    and its arguments (for the detail); with `fwd` the prepared forward
    launch and its arguments."""
    _, bs, slots, feats, mn, sn, *od = case
    gen = torch.Generator().manual_seed(500 + i)
    tb = _batch(CS, bs, slots, device)
    f = int(tb["node_feats"].shape[1]) if feats else 8
    od = od[0] if od else 4 * f if feats else 16
    c, _ = CS._ps_case(tb, f, od, gen, device, from_feats=feats)
    with torch.no_grad():
        det = lambda x: ({k: det(v) for k, v in x.items()}
                         if isinstance(x, dict) else
                         [det(v) for v in x] if isinstance(x, list) else
                         x.detach() if isinstance(x, torch.Tensor) else x)
        c = {k: det(v) for k, v in c.items()}
        weights, meta = P.flat_weights(
            c["amat"], c["a0"], c["mbias"], c["gru"], c["ma_bns"],
            c["bns"], c["ro"], c["h0"], steps=3, msg_norm=mn,
            state_norm=sn)
        fargs = (weights, c["h0"], c["mask"], c["node_graph"], c["labels"],
                 c["gmask"], c["vid"], c["src"], c["dst"], c["plan"], meta)
        pf = P.prepare_fused_psteps_fwd(*fargs)
        if fwd:
            return pf, fargs
        _, out, stats, htil = K.launch_prepared(pf)
        gout = torch.randn(out.shape, generator=gen).to(device)
        gl = torch.ones(1, device=device)
        args = (weights, c["h0"], c["labels"], c["gmask"], out, gout, gl,
                htil, stats, c["node_graph"], c["vid"], c["src"], c["dst"],
                c["plan"], meta)
        return P.prepare_fused_psteps_bwd(*args), args


def _time(CS, K, p, reps):
    ms = CS._events_ms(lambda: K.launch_prepared(p), reps)
    trace = CS._kernel_trace_us_n(20, p)[0] / 20 / 1e3
    return {"ms": ms, "trace_ms": trace}


def _shape(P, K, args, device):
    weights, h0, meta = args[0], args[1], args[-1]
    od = dict(weights)["ro_ib"].shape[0]
    tag = K.width_bucket("", P.BUCKETS, f=h0.shape[1], od=od,
                         steps=meta.steps)
    return P.device_bwd_shape(h0.shape[0], tag,
                              dict(weights)["amat"].shape[1], meta.steps,
                              meta.state_mode != P.NONE, device), tag


def _detail(CS, P, K, args, device):
    return CS._walk_detail(
        lambda **kw: P.prepare_fused_psteps_bwd(*args, **kw),
        lambda: _shape(P, K, args, device)[0],
        lambda pr: CS._ps_bwd_phases(pr, args[-1].steps), P.launch_counts,
        device)


def _sweep(CS, P, K, args, reps, device):
    """The backward on the rule's route and each forced neighbour
    (chip_smoke.py::_ps_route): '<route tag> <events us> (trace us)'."""
    rule, tag = _shape(P, K, args, device)
    n = args[1].shape[0]
    most = P._lib("fused_psteps_bwd", tag).mpnn_fused_psteps_bwd_max_grid(
        rule.smem_bytes)
    routes = [(None, None)] + [
        (f"cluster {c}", None) for c in (1, 2, 4, 8)
        if -(-n // c) <= 3 * rule.ncap // 4] + [
        ("grid", g) for g in sorted({max(2, min(most, -(-n // per)))
                                     for per in (8, 16, 32, 64, 128)})]
    res = []
    for route, grid in routes:
        with CS._ps_route(route, grid):
            p = P.prepare_fused_psteps_bwd(*args)
            shape = _shape(P, K, args, device)[0]
        t = _time(CS, K, p, reps)
        res.append(f"{'rule ' if route is None else ''}{shape.tag()} "
                   f"{t['ms'] * 1e3:.2f} us (trace "
                   f"{t['trace_ms'] * 1e3:.2f})")
    return [f"{n} slots"] + res


def _fwd_shape(P, K, fargs, device):
    weights, h0, meta = fargs[0], fargs[1], fargs[-1]
    w = dict(weights)
    tag = K.width_bucket("", P.BUCKETS, f=h0.shape[1],
                         od=w["ro_ib"].shape[0], steps=meta.steps)
    return P.device_fwd_shape(
        h0.shape[0], tag, w["amat"].shape[1], meta.steps,
        meta.msg_mode != P.NONE or meta.state_mode != P.NONE, device)


def _fwd_sweep(CS, P, K, fargs, reps, device):
    """The forward on the rule's route and each forced neighbour
    (chip_smoke.py::_ps_fwd_route): '<route tag> <events us> (trace us)'."""
    rule = _fwd_shape(P, K, fargs, device)
    n = fargs[1].shape[0]
    most = max(rule.grid, P._lib("fused_psteps_fwd", "" if fargs[1].shape[1]
                                 <= 16 else "f32")
               .mpnn_fused_psteps_fwd_max_grid(rule.smem_bytes))
    routes = [(None, None)] + [
        (f"cluster {c}", None) for c in (1, 2, 4, 8)
        if -(-n // c) <= 3 * rule.ncap // 4] + [
        ("grid", g) for g in sorted({max(2, min(most, -(-n // per)))
                                     for per in (8, 16, 24, 32, 64, 128)})]
    res = []
    for route, grid in routes:
        with CS._ps_fwd_route(route, grid):
            p = P.prepare_fused_psteps_fwd(*fargs)
            shape = _fwd_shape(P, K, fargs, device)
        t = _time(CS, K, p, reps)
        res.append(f"{'rule ' if route is None else ''}{shape.tag()} "
                   f"{t['ms'] * 1e3:.2f} us (trace "
                   f"{t['trace_ms'] * 1e3:.2f})")
    return [f"{n} slots"] + res


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fwd", action="store_true",
                    help="time the training forward (fused_psteps_fwd)")
    ap.add_argument("--cases", default="",
                    help="comma-separated case-name prefixes (default all)")
    args = ap.parse_args(argv)
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_psteps: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    wanted = [c for c in args.cases.split(",") if c]
    out, sweep = {}, {}
    for i, case in enumerate(CASES):
        name = case[0]
        if wanted and not any(name.startswith(c) for c in wanted):
            continue
        if args.fwd:
            pf, fargs = _case(CS, P, K, i, case, device, fwd=True)
            out[name] = _time(CS, K, pf, args.reps)
            line = (f"fwd {name} ({fargs[1].shape[0]} slots): "
                    f"{out[name]['ms'] * 1e3:.2f} us (trace "
                    f"{out[name]['trace_ms'] * 1e3:.2f})")
            if args.detail and hasattr(CS, "_ps_fwd_detail"):
                route, floor_ms, phases = CS._ps_fwd_detail(fargs, device)
                out[name].update(route=route, floor_ms=floor_ms, phases={
                    k: round(v) for k, v in phases.items()})
                line += (f", route {route}, empty-forward floor "
                         f"{floor_ms * 1e3:.2f} us, clock64 cycles "
                         + json.dumps(out[name]["phases"]))
            print(line, flush=True)
            if args.sweep and hasattr(CS, "_ps_fwd_route") \
                    and "wide" not in name:
                sweep[name] = _fwd_sweep(CS, P, K, fargs, args.reps, device)
                print(f"sweep fwd {name}: " + "; ".join(sweep[name]),
                      flush=True)
            continue
        pb, bargs = _case(CS, P, K, i, case, device)
        out[name] = _time(CS, K, pb, args.reps)
        line = (f"{name} ({bargs[1].shape[0]} slots): "
                f"{out[name]['ms'] * 1e3:.2f} us (trace "
                f"{out[name]['trace_ms'] * 1e3:.2f})")
        if args.detail and hasattr(CS, "_walk_detail"):
            route, floor_ms, phases = _detail(CS, P, K, bargs, device)
            out[name].update(route=route, floor_ms=floor_ms,
                             phases={k: round(v) for k, v in phases.items()})
            line += (f", route {route}, empty-walk floor "
                     f"{floor_ms * 1e3:.2f} us, clock64 cycles "
                     + json.dumps(out[name]["phases"]))
        print(line, flush=True)
        if args.sweep and hasattr(CS, "_ps_route") and "wide" not in name \
                and "28,672" not in name:
            sweep[name] = _sweep(CS, P, K, bargs, args.reps, device)
            print(f"sweep {name}: " + "; ".join(sweep[name]), flush=True)
    print(json.dumps({"label": args.label, "card": card, "times": out,
                      "sweep": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
