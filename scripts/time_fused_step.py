"""Time the whole-step training backward (fused_step_bwd) of the checkout
in the working directory, so that two commits can be held against each
other on one card:

    cd <checkout> && python <this repo>/scripts/time_fused_step.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its
shared-family kernels and times, with CUDA events over back-to-back
launches (and beside them the device time a launch in a torch.profiler
trace of 20), the backward on the forward's residuals at:
lipo's widths (f 10, od 14, T 6) at batch 16, 40 (near the rule's
cluster/grid boundary) and 1024 of bench.py's molecules, bn1d/bn1d, and
at 16 and 1024 bn1d/stateless; the basic shell's (f 7, od 28,
T 3: the o64 build) at b16 and b1024, none/none and none/stateless; and
the wide phase's shapes at its b16 (afm 27): lipo at f 30, od 54 (the f32
build, bn1d/bn1d) and the basic shell at f 27, od 108 (the o128 build,
none/none and bn1d/stateless). Each case's data comes from its own seed,
the same in every checkout. Run it on both commits in turns (parent,
change, change, parent).

--split also times the split route's three launches (ro_bwd,
recurrence_bwd, msg_bwd) beside the whole backward at lipo b1024 and
b3584 (the trained lipo network, chip_smoke.py::_split_launches).
--detail (a checkout whose chip_smoke.py has _bwd_detail) prints each
case's route, empty-walk floor and block 0's clock64 phases. --sweep (a
checkout whose chip_smoke.py has _bwd_route; --sweep-cases picks some)
times the backward of lipo's bn1d/bn1d at b16 to b1024 (256 to 13,184
node slots), lipo's bn1d/none and the basic shell's none/none (no
state norm) and none/stateless on the rule's own route and its
neighbours on both routes: one cluster of 1, 2, 4 and 8 blocks (1-4
while a block's share is at most 1,024 slots) and the grid at one block
per 8, 16, 32, 64, 100, 128 and 256 slots, capped at the card's
co-resident blocks: the measurement behind the rule's
CLUSTER_SLOTS and GRID_NODES. --step times lipo's whole train step
(chip_smoke.py's trained network; host clock ending in the loss read
back) at b16 and b1024, medians of 60 and 30 after 5, and the host time
of the backward's wrapper (prepare and launch, no sync; median of 200).
--witness holds the backward on two batches where float32 sits past
1e-5 of the exact gradients (T 32 without a message norm; a 4,000-node
graph, as tests/test_torch_gpu.py::test_cuda_step_kernels_against_float64
builds them) against the plain float32 version and a float64 run of it,
and prints each leaf's distances from the float64 answer.

--fwd also times the training forward (fused_step_fwd) and, for the
stateless state norm, the serving kernel (fused_eval_stateless) on the
same cases, and with --detail (a checkout whose chip_smoke.py has
_fwd_detail) their route, empty-forward floor and block 0's clock64
phases. --fwd --sweep (a checkout whose chip_smoke.py has _fwd_route)
times the training forward of lipo's bn1d/bn1d at b16 to b1024, the
basic shell's none/none and none/stateless, on the forward rule's own
route and on its neighbours: one cluster of 1, 2, 4 and 8 blocks and the
grid at a block per 16, 24, 32, 48, 64, 96, 128 and 256 slots, capped at
the card's co-resident blocks: the measurement behind FWD_CLUSTER_SLOTS,
FWD_CLUSTER_NODES and FWD_GRID_NODES.

--eval times the folded-norm serving kernel (fused_eval, row 1) alone on
EVAL_CASES: lipo bn1d/bn1d at b16, b128 and b1024, the basic shell's
none/none (o64 build) at b16 and b1024, wide lipo at b16 (f 30, the f32
build) and the wide basic shell at b16 and b1024 (f 27, od 108, the o128
build), with --detail (a checkout with kernels/fused_step.py::
device_eval_shape) its route, empty-kernel floor and block 0's clock64
phases. --eval --sweep (the same checkout) times each case on the rule's
route and at a block per 8, 16, 32, 64 and 128 node slots (the free
route's blocks never wait on each other, so no cap), ranked on the
trace's device time: the measurement behind EVAL_NODES.

Prints one JSON line: {"label", "card", "times": {case: {"ms",
"trace_ms"}}, "fwd": {case: {...}}, "eval": {case: {...}}, "split":
{...}, "step": {...}, "witness": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

# (name, batch, h0 with nafm, od of afm (lipo 2·afm, basic 4·afm), T,
# msg norm, state norm)
CASES = [
    ("lipo b16 bn1d/bn1d", 16, True, 2, 6, "bn1d", "bn1d"),
    ("lipo b40 bn1d/bn1d", 40, True, 2, 6, "bn1d", "bn1d"),
    ("lipo b1024 bn1d/bn1d", 1024, True, 2, 6, "bn1d", "bn1d"),
    ("lipo b16 bn1d/stateless", 16, True, 2, 6, "bn1d", "stateless"),
    ("lipo b1024 bn1d/stateless", 1024, True, 2, 6, "bn1d", "stateless"),
    ("basic b16 none/none", 16, False, 4, 3, "none", "none"),
    ("basic b1024 none/none", 1024, False, 4, 3, "none", "none"),
    ("basic b16 none/stateless", 16, False, 4, 3, "none", "stateless"),
    ("basic b1024 none/stateless", 1024, False, 4, 3, "none", "stateless"),
    ("wide lipo b16 bn1d/bn1d (f32)", -16, True, 2, 6, "bn1d", "bn1d"),
    ("wide basic b16 none/none (o128)", -16, False, 4, 3, "none", "none"),
    ("wide basic b16 bn1d/stateless (o128)", -16, False, 4, 3, "bn1d",
     "stateless"),
]


# the folded serving kernel's cases: (name, batch, h0 with nafm, od of afm,
# T, msg norm, state norm)
EVAL_CASES = [
    ("lipo b16 bn1d/bn1d", 16, True, 2, 6, "bn1d", "bn1d"),
    ("lipo b128 bn1d/bn1d", 128, True, 2, 6, "bn1d", "bn1d"),
    ("lipo b1024 bn1d/bn1d", 1024, True, 2, 6, "bn1d", "bn1d"),
    ("basic b16 none/none (o64)", 16, False, 4, 3, "none", "none"),
    ("basic b1024 none/none (o64)", 1024, False, 4, 3, "none", "none"),
    ("wide lipo b16 bn1d/bn1d (f32)", -16, True, 2, 6, "bn1d", "bn1d"),
    ("wide basic b16 none/none (o128)", -16, False, 4, 3, "none", "none"),
    ("wide basic b1024 none/none (o128)", -1024, False, 4, 3, "none",
     "none"),
]
EVAL_SWEEP_NODES = (8, 16, 32, 64, 128)


def _eval_times(CS, K, i, case, reps, detail, sweep, device):
    """The folded serving kernel on a case: events and trace; with
    `detail` its route, floor and clock64 phases; with `sweep` each forced
    block size beside the rule's."""
    _, _, eval_args, meta = _case(CS, K, 600 + i, case, device)
    kw = dict(steps=case[4], msg_norm=case[5], state_norm=case[6])
    n, f = eval_args[3].shape
    od = eval_args[11]["i"]["b"].shape[0]
    k = eval_args[0].shape[0]
    g = eval_args[15].graph_node_ptr.shape[0] - 1
    tag = K.width_bucket("", K.BUCKETS, f=f, od=od)
    with torch.no_grad():
        pe = K.prepare_fused_eval(*eval_args, **kw, check=False)
        out = _time(CS, K, pe, reps)
        routed = hasattr(K, "device_eval_shape")
        if detail and routed:
            pfl = K.prepare_fused_eval(*eval_args, **kw, check=False,
                                       floor=True)
            prof = torch.zeros(K.FWD_PROF_SLOTS, dtype=torch.int64,
                               device=device)
            K.launch_prepared(K.prepare_fused_eval(*eval_args, **kw,
                                                   check=False, prof=prof))
            torch.cuda.synchronize()
            out.update(
                route=K.device_eval_shape(n, tag, k, case[4], device,
                                          g).tag(),
                floor_ms=CS._events_ms(lambda: K.launch_prepared(pfl), 100),
                phases={a: round(b) for a, b in
                        CS._fwd_phases(prof.tolist(), case[4]).items()})
        if sweep and hasattr(CS, "_eval_route"):
            row = {}
            for route in (None, *(f"nodes {p}" for p in EVAL_SWEEP_NODES)):
                with CS._eval_route(route):
                    pr = K.prepare_fused_eval(*eval_args, **kw, check=False)
                    t = K.device_eval_shape(n, tag, k, case[4], device,
                                            g).tag()
                row[f"{route or 'rule'} ({t})"] = _time(CS, K, pr, reps)
            row["ranked on trace"] = sorted(
                row, key=lambda r: row[r]["trace_ms"])
            out["sweep"] = row
    return out


def _batch(CS, bs, device):
    from mpnn_tpu_torch.train.trainer import batch_to_device
    smiles = CS.WIDE_SMILES if bs < 0 else CS.SMILES
    n = abs(bs)
    return batch_to_device(CS._batch((smiles * (n // len(smiles) + 1))[:n],
                                     n), device)


def _case(CS, K, i, case, device):
    """The prepared forward and backward launches of a case and its
    batch's node slots."""
    _, bs, nafm, per_afm, T, mn, sn = case
    gen = torch.Generator().manual_seed(300 + i)
    tb = _batch(CS, bs, device)
    afm = tb["node_feats"].shape[1]
    f = afm + (tb["node_nafm"].shape[1] if nafm else 0)
    od = per_afm * afm
    k = int(tb["edge_vfirst"].shape[0])
    w = CS._random_weights(f, od, k, gen, device)
    args = CS._shell_args(tb, w, nafm)
    meta = K.StepMeta(T, K.BATCH_BN if mn == "bn1d" else K.NONE,
                      K._STATE_MODE[sn])
    with torch.no_grad():
        pf, pb, _, _ = CS._prep_step(args, meta, gen, None, device)
    return pf, pb, args, meta


def _time(CS, K, p, reps):
    ms = CS._events_ms(lambda: K.launch_prepared(p), reps)
    trace = CS._kernel_trace_us_n(20, p)[0] / 20 / 1e3
    return {"ms": ms, "trace_ms": trace}


def _detail(CS, K, pb, eval_args, meta, device):
    """Route, floor, clock64 phases of the backward on pb's inputs."""
    (amat, a0, mbias, h0, _, ng, gru, ma, _, bn, _, ro, vid, src, dst,
     plan) = eval_args
    weights = K._flat_weights(amat, a0, mbias, gru, ma, bn, ro)
    labels, gmask, o, gout, gl, htil, st = pb.keep[16:23]
    return CS._bwd_detail(weights, h0, labels, gmask, o, gout, gl, htil, st,
                          ng, vid, src, dst, plan, meta, device)


# the rule's sweep: lipo bn1d/bn1d from 256 to 13,184 node slots, lipo
# bn1d/none and the basic shell's none/none (no step sums) and
# none/stateless
SWEEP = [(f"lipo b{bs} bn1d/bn1d", bs, True, 2, 6, "bn1d", "bn1d")
         for bs in (16, 24, 32, 40, 64, 80, 160, 256, 1024)] + [
    (f"lipo b{bs} bn1d/none", bs, True, 2, 6, "bn1d", "none")
    for bs in (16, 40)] + [
    (f"basic b{bs} none/none", bs, False, 4, 3, "none", "none")
    for bs in (16, 40, 1024)] + [
    ("basic b16 none/stateless", 16, False, 4, 3, "none", "stateless")]


def _sweep(CS, K, case, reps, device):
    """The backward of `case` on the rule's route and on each forced
    neighbour (chip_smoke.py::_bwd_route): '<route tag> <events us>'."""
    _, _, eval_args, meta = _case(CS, K, 100 + case[1], case, device)
    n, f = eval_args[3].shape
    tag = K.width_bucket("", K.BUCKETS, f=f,
                         od=eval_args[11]["i"]["b"].shape[0])
    k = eval_args[0].shape[0]
    sums = meta.state_mode != K.NONE
    rule = K.device_bwd_shape(n, tag, k, meta.steps, sums, device)
    most = K._lib("fused_step_bwd", tag=tag).mpnn_fused_step_bwd_max_grid(
        rule.smem_bytes)
    routes = [(None, None)] + [
        (f"cluster {c}", None) for c in (1, 2, 4, 8)
        if c == 8 or -(-n // c) <= K.MAX_NCAP] + [
        ("grid", g) for g in sorted({max(2, min(most, -(-n // per)))
                                     for per in (8, 16, 32, 64, 100, 128,
                                                 256)})]
    res = []
    for route, grid in routes:
        with CS._bwd_route(route, grid):
            with torch.no_grad():
                _, p, _, _ = CS._prep_step(
                    eval_args, meta, torch.Generator().manual_seed(
                        400 + case[1]), None, device)
            shape = K.device_bwd_shape(n, tag, k, meta.steps, sums, device)
        t = _time(CS, K, p, reps)
        res.append(f"{'rule ' if route is None else ''}{shape.tag()} "
                   f"{t['ms'] * 1e3:.2f} us (trace "
                   f"{t['trace_ms'] * 1e3:.2f})")
    return [f"{n} slots"] + res


def _fwd_times(CS, K, pf, eval_args, meta, reps, detail, device):
    """The training forward's and (stateless state norm) the serving
    kernel's times on a case; with `detail`, their route, floor and
    clock64 phases."""
    out = {"fused_step_fwd": _time(CS, K, pf, reps)}
    kw = dict(steps=meta.steps,
              msg_norm="bn1d" if meta.msg_mode == K.BATCH_BN else "none",
              state_norm={v: k for k, v in K._STATE_MODE.items()}[
                  meta.state_mode])
    n, f = eval_args[3].shape
    od = eval_args[11]["i"]["b"].shape[0]
    k = eval_args[0].shape[0]
    tag = K.width_bucket("", K.BUCKETS, f=f, od=od)
    if kw["state_norm"] == "stateless":
        with torch.no_grad():
            pe = K.prepare_fused_eval(*eval_args, **kw, check=False)
        out["fused_eval_stateless"] = _time(CS, K, pe, reps)
    if detail and hasattr(CS, "_fwd_detail"):
        (amat, a0, mbias, h0, mask, ng, gru, ma, _, bn, _, ro, vid, src,
         dst, plan) = eval_args
        labels, gmask = pf.keep[16:18]
        weights = K._flat_weights(amat, a0, mbias, gru, ma, bn, ro)
        sums = meta.msg_mode != K.NONE or meta.state_mode != K.NONE
        with torch.no_grad():
            out["fused_step_fwd"]["detail"] = CS._fwd_detail(
                lambda **kw2: K.prepare_fused_step_fwd(
                    weights, h0, mask, ng, labels, gmask, vid, src, dst,
                    plan, meta, **kw2), n, tag, k, meta.steps, sums, device,
                "fused_step_fwd")
            if kw["state_norm"] == "stateless":
                out["fused_eval_stateless"]["detail"] = CS._fwd_detail(
                    lambda **kw2: K.prepare_fused_eval(
                        *eval_args, **kw, check=False, **kw2), n, tag, k,
                    meta.steps, True, device, "fused_eval")
    return out


FWD_SWEEP = [(f"lipo b{bs} bn1d/bn1d", bs, True, 2, 6, "bn1d", "bn1d")
             for bs in (16, 24, 32, 40, 64, 128, 256, 512, 1024)] + [
    (f"basic b{bs} none/none", bs, False, 4, 3, "none", "none")
    for bs in (16, 40, 1024)] + [
    (f"basic b{bs} none/stateless", bs, False, 4, 3, "none", "stateless")
    for bs in (16, 1024)]


def _fwd_sweep(CS, K, case, reps, device):
    """The training forward of `case` on the forward rule's route and on
    each forced neighbour (chip_smoke.py::_fwd_route)."""
    _, _, eval_args, meta = _case(CS, K, 100 + case[1], case, device)
    n, f = eval_args[3].shape
    tag = K.width_bucket("", K.BUCKETS, f=f,
                         od=eval_args[11]["i"]["b"].shape[0])
    k = eval_args[0].shape[0]
    sums = meta.msg_mode != K.NONE or meta.state_mode != K.NONE
    rule = K.device_fwd_shape(n, tag, k, meta.steps, sums, device)
    most = K._lib("fused_step_fwd", tag=tag).mpnn_fused_step_fwd_max_grid(
        rule.smem_bytes)
    routes = [(None, None)] + [(f"cluster {c}", None) for c in (1, 2, 4, 8)
                               ] + [
        ("grid", g) for g in sorted({max(2, min(most, -(-n // per)))
                                     for per in (16, 24, 32, 48, 64, 96,
                                                 128, 256)})]
    res = []
    for route, grid in routes:
        with CS._fwd_route(route, grid):
            with torch.no_grad():
                p, _, _, _ = CS._prep_step(
                    eval_args, meta, torch.Generator().manual_seed(
                        400 + case[1]), None, device)
            shape = K.device_fwd_shape(n, tag, k, meta.steps, sums, device)
        t = _time(CS, K, p, reps)
        res.append(f"{'rule ' if route is None else ''}{shape.tag()} "
                   f"{t['ms'] * 1e3:.2f} us (trace "
                   f"{t['trace_ms'] * 1e3:.2f})")
    return [f"{n} slots"] + res


def _step(CS, K, device):
    """lipo's train step (host clock ending in the loss read back) at b16
    and b1024, and the host time of the backward's wrapper alone."""
    import statistics
    import time
    from mpnn_tpu_torch.models.fused_train import fused_step_args
    from mpnn_tpu_torch.models.network import mpnn_input
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    out = {}
    gen = torch.Generator().manual_seed(2)
    for bs, reps in ((16, 60), (1024, 30)):
        b = CS._batch((CS.SMILES * (bs // len(CS.SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randn(bs, generator=gen).numpy()
        tb = batch_to_device(b, device)
        net, opt = CS._train_net(b, gen, device)
        for _ in range(5):
            float(train_step(net, opt, tb))
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(train_step(net, opt, tb))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        mb, _ = mpnn_input(net, tb, training=True)
        args, kw = fused_step_args(net.mpnn, mb, tb["labels"])
        det = lambda x: ({k: det(v) for k, v in x.items()}
                         if isinstance(x, dict) else x.detach()
                         if isinstance(x, torch.Tensor) else x)
        (amat, a0, mbias, h0, mask, ng, gru, ma, bnp, ro, labels, gmask,
         vid, src, dst, plan) = [det(a) for a in args]
        weights = K._flat_weights(amat, a0, mbias, gru, ma, bnp, ro)
        meta = K.StepMeta(kw["steps"], 1, 1)
        pf = K.prepare_fused_step_fwd(weights, h0, mask, ng, labels, gmask,
                                      vid, src, dst, plan, meta)
        _, o, st, htil = K.launch_prepared(pf)
        gout = torch.randn(o.shape, generator=gen).to(device)
        gl = torch.ones(1, device=device)
        host = []
        for i in range(200):
            t0 = time.perf_counter()
            K.launch_prepared(K.prepare_fused_step_bwd(
                weights, h0, labels, gmask, o, gout, gl, htil, st, ng, vid,
                src, dst, plan, meta))
            host.append((time.perf_counter() - t0) * 1e6)
            if i % 50 == 49:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        lat.sort()
        out[f"lipo b{bs}"] = {
            "step_ms_median": statistics.median(lat),
            "step_ms_p10": lat[len(lat) // 10],
            "step_ms_p90": lat[9 * len(lat) // 10],
            "bwd_wrapper_host_us_median": statistics.median(host)}
        print(f"step lipo b{bs}: " + json.dumps(out[f"lipo b{bs}"]),
              flush=True)
    return out


# (name, graphs, nodes of graph g // 2, T, msg norm, state norm, route);
# the data as tests/test_torch_gpu.py::test_cuda_step_kernels_against_
# float64 makes it
WITNESS = [("T 32 none/bn1d", 64, 0, 32, "none", "bn1d", None),
           ("T 32 none/bn1d grid", 64, 0, 32, "none", "bn1d", "grid"),
           ("4,000-node graph none/none", 4, 4000, 3, "none", "none", None),
           ("4,000-node graph bn1d/bn1d", 4, 4000, 6, "bn1d", "bn1d", None),
           ("4,000-node graph bn1d/bn1d cluster 8", 4, 4000, 6, "bn1d",
            "bn1d", "cluster 8")]


def _witness(CS, K):
    """Per leaf, the backward's and the plain float32 version's distance
    from a float64 run of the plain version (scaled by the float64 leaf's
    max abs), and the backward's from the plain version: {case: {leaf:
    [kernel-float64, plain-float64, kernel-plain]}}. The test helpers are
    this script's repo's; the kernel is the working directory's. A route
    is forced only where that checkout can force it."""
    import contextlib
    import importlib.util
    import numpy as np
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "_gpu_tests", os.path.join(here, "tests", "test_torch_gpu.py"))
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)
    out = {}
    for name, g, big, steps, mn, sn, route in WITNESS:
        if route and not hasattr(CS, "_bwd_route"):
            continue
        rng = np.random.RandomState(7 * g + steps + 8 + big)
        args, leaves = T._step_problem(rng, g, big=big)
        cw = torch.as_tensor(rng.randn(g, 14).astype(np.float32),
                             device="cuda")
        kw = dict(steps=steps, msg_norm=mn, state_norm=sn)
        force = (CS._bwd_route(route) if hasattr(CS, "_bwd_route")
                 else contextlib.nullcontext())
        with force:
            got = T.step_and_grads(K.fused_step, args, leaves, cw, **kw)
        want = T.step_and_grads(K.fused_step_reference, args, leaves, cw,
                                **kw)
        exact = T.float64_step_and_grads(args, cw, **kw)
        dist = T.exactness(got, want, exact, mn)
        rows = {}
        for leaf, (k64, p64) in dist.items():
            a, b = ((got[0], want[0]) if leaf == "loss" else
                    (got[1], want[1]) if leaf == "out" else
                    (got[4][leaf], want[4][leaf]))
            kp = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            rows[leaf] = [k64, p64, kp]
        out[name] = rows
        print(f"witness {name}: " + ", ".join(
            f"{leaf} {v[0]:.1e}/{v[1]:.1e}/{v[2]:.1e}"
            for leaf, v in rows.items()), flush=True)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--fwd", action="store_true")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--cases", default="",
                    help="comma-separated case-name prefixes (default all)")
    ap.add_argument("--sweep-cases", default="",
                    help="comma-separated sweep-case prefixes (default all)")
    args = ap.parse_args(argv)
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_step as K
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    wanted = [c for c in args.cases.split(",") if c]
    out, split, fwd, ev = {}, {}, {}, {}
    for i, case in enumerate(EVAL_CASES if args.eval else []):
        name = case[0]
        if wanted and not any(name.startswith(c) for c in wanted):
            continue
        ev[name] = _eval_times(CS, K, i, case, args.reps, args.detail,
                               args.sweep, device)
        print(json.dumps({f"fused_eval {name}": ev[name]}), flush=True)
    for i, case in enumerate([] if args.eval else CASES):
        name = case[0]
        if wanted and not any(name.startswith(c) for c in wanted):
            continue
        pf, pb, eval_args, meta = _case(CS, K, i, case, device)
        out[name] = _time(CS, K, pb, args.reps)
        if args.fwd:
            fwd[name] = _fwd_times(CS, K, pf, eval_args, meta, args.reps,
                                   args.detail, device)
            print(f"{name}: " + ", ".join(
                f"{kn} {v['ms'] * 1e3:.2f} us (trace "
                f"{v['trace_ms'] * 1e3:.2f})"
                + (f" route {v['detail'][0]}, floor "
                   f"{v['detail'][1] * 1e3:.2f} us, clock64 "
                   + json.dumps({a: round(b) for a, b in
                                 v['detail'][2].items()})
                   if "detail" in v else "")
                for kn, v in fwd[name].items())
                + f"; fused_step_bwd {out[name]['ms'] * 1e3:.2f} us",
                flush=True)
        if args.detail and hasattr(CS, "_bwd_detail"):
            route, floor_ms, phases = _detail(CS, K, pb, eval_args, meta,
                                              device)
            out[name].update(route=route, floor_ms=floor_ms)
            print(f"{name}: route {route}, empty-walk floor "
                  f"{floor_ms * 1e3:.2f} us, clock64 cycles "
                  + json.dumps({k: round(v) for k, v in phases.items()}),
                  flush=True)
    if args.split:
        from mpnn_tpu_torch.train.trainer import batch_to_device
        for bs in (1024, 3584):
            gen = torch.Generator().manual_seed(400 + bs)
            b = CS._batch((CS.SMILES * (bs // len(CS.SMILES) + 1))[:bs], bs)
            b["labels"] = torch.randn(bs, generator=gen).numpy()
            tb = batch_to_device(b, device)
            net, _ = CS._train_net(b, gen, device)
            prep, _, _ = CS._split_launches("shared", net, tb, gen)
            t = {k: _time(CS, K, p, args.reps) for k, p in prep.items()}
            split[f"lipo b{bs} ({b['node_mask'].shape[0]} slots)"] = t
    if args.eval:
        pass
    elif args.fwd and args.sweep and hasattr(CS, "_fwd_route"):
        picked = [c for c in args.sweep_cases.split(",") if c]
        for case in FWD_SWEEP:
            if picked and not any(case[0].startswith(c) for c in picked):
                continue
            print(f"fwd sweep {case[0]}: " + "; ".join(
                _fwd_sweep(CS, K, case, args.reps, device)), flush=True)
    elif args.sweep and hasattr(CS, "_bwd_route"):
        picked = [c for c in args.sweep_cases.split(",") if c]
        for case in SWEEP:
            if picked and not any(case[0].startswith(c) for c in picked):
                continue
            print(f"sweep {case[0]}: " + "; ".join(
                _sweep(CS, K, case, args.reps, device)), flush=True)
    step = _step(CS, K, device) if args.step else {}
    witness = _witness(CS, K) if args.witness else {}
    for v in fwd.values():
        for t in v.values():
            t.pop("detail", None)
    print(json.dumps({"label": args.label, "card": card, "times": out,
                      "fwd": fwd, "eval": ev, "split": split, "step": step,
                      "witness": witness}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
