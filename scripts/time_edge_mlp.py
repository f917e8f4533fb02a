"""Time the edge-MLP chain kernels of the checkout in the working
directory, so that two commits can be held against each other on one
card:

    cd <checkout> && python <this repo>/scripts/time_edge_mlp.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke, builds its
edge-MLP kernels and times, with CUDA events over repeated launches, the
forward and the backward of the ×50 chain at the shapes of that checkout's
chip_smoke.py::_mlp_cases (each model's edge network on bench.py's b1024
vocab rows, then pf 16, 49, 64 and 256 at the zoo's head schedules; a
newer checkout appends more cases, seeded after the common ones, so the
common cases get the same data in both). Run it on both commits in turns
(parent, change, change, parent); --cases takes a subset by name prefix,
and --cases-of DIR takes the cases of DIR/chip_smoke.py instead (a newer
checkout's shapes, timed on this checkout's kernels).
Prints one JSON line: {"label", "card", "times": {case: {kernel: ms}}}
(CUDA events over back-to-back launches, and `<kernel>_trace_ms`: the
device time a launch in a torch.profiler trace);
with --detail, first a line per case with device times from a trace, the
empty-chain floor and the clock64 phases (chip_smoke.py::_mlp_detail,
where the checkout has it); with --sweep (a checkout whose kernels take
kernels/edge_mlp.py::MlpShape's C arguments), first a line per
register-route case with both kernels' times (events and trace) at each
rows-a-block the route can take, launched through the C entry points
with that rows-a-block: the measurement behind the rule's REG_ROWS.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())


def launch_at(M, K, direction, rb, x, ws, bs, sw, g):
    """A prepared launch of the register route with `rb` rows a block,
    whatever the rule picks: the C entry point's arguments as
    kernels/edge_mlp.py's prepare functions build them (the library
    refuses a shape that is not a launch of its kernels)."""
    rows, dims = x.shape[0], [x.shape[1]] + [w.shape[1] for w in ws]
    kp, h, n = M.reg_kp(dims[-1]), len(ws), -(-rows // rb)
    c = (rb, 1, kp, 0)                   # (rb, cluster, kp, l2)
    lib = M._lib(f"edge_mlp_{direction}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), M._pointers(ws), M._pointers(bs), sw.data_ptr(),
            M._int_array(dims), h, rows, 50, *c)
    kw = dict(dtype=torch.float32, device=x.device)
    counts = dict.fromkeys(M.launch_counts, 0)     # not the library's
    if direction == "fwd":
        out = torch.empty(rows, dims[-1], **kw)
        return K.PreparedLaunch(
            "edge_mlp_fwd", lib.mpnn_edge_mlp_fwd, lib.mpnn_cuda_error_string,
            head + (out.data_ptr(), None, stream), out, (out,), counts)
    dx = torch.empty(rows, dims[0], **kw)
    dw = torch.empty(M.grad_layout(dims)["total"][0], **kw)
    nf = lib.mpnn_edge_mlp_bwd_scratch_floats(M._int_array(dims), h, rows,
                                              50, *c)
    scratch = torch.empty(max(nf, 1), **kw)
    counters = M._counters(x.device, stream) if n > 1 else None
    return K.PreparedLaunch(
        "edge_mlp_bwd", lib.mpnn_edge_mlp_bwd, lib.mpnn_cuda_error_string,
        head + (g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                scratch.data_ptr() if nf else None,
                None if counters is None else counters.data_ptr(), None,
                stream), (dx, dw), (dx, dw, scratch, counters), counts)


def sweep(CS, M, K, x, ws, bs, sw, g, reps):
    """Both kernels' times (events over `reps` launches; the device time a
    launch in a trace of 20) at every rows-a-block of the register route
    that fits, beside the rule's."""
    rows, dims = x.shape[0], [x.shape[1]] + [w.shape[1] for w in ws]
    pf = dims[-1]
    if pf > M.REG_MAX_PF:
        return "panel route: no sweep"
    kp, out = M.reg_kp(pf), []
    smem = torch.cuda.get_device_properties(x.device)
    rule = {d: M.device_shape(d, rows, dims, 50, x.device).rb
            for d in ("fwd", "bwd")}
    for rb in sorted({1, 2, 3, 4, 5, 6, 8, 9, 12, 16} & set(
            range(1, min(rows, 15, M.reg_max_threads(kp)
                         // M.reg_lanes(kp)) + 1))):
        t = {}
        for d in ("fwd", "bwd"):
            if 4 * M.smem_floats(d, dims, 50, kp, 1, rb) > \
                    smem.shared_memory_per_block_optin:
                continue
            p = launch_at(M, K, d, rb, x, ws, bs, sw, g)
            t[d] = (CS._events_ms(lambda p=p: K.launch_prepared(p), reps)
                    * 1e3, CS._kernel_trace_us_n(20, p)[0] / 20)
        out.append(f"rb {rb}: " + ", ".join(
            f"{d} {ev:.2f} us (trace {tr:.2f})"
            + (" (rule)" if rule[d] == rb else "")
            for d, (ev, tr) in t.items()))
    return "; ".join(out)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cases", default="",
                    help="comma-separated case-name prefixes (default all)")
    ap.add_argument("--cases-of", default="",
                    help="a checkout whose chip_smoke.py gives the cases")
    args = ap.parse_args(argv)
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.kernels import fused_step as K
    cases_of = CS                        # its mpnn_tpu_torch: this one's
    if args.cases_of:
        spec = importlib.util.spec_from_file_location(
            "cases_of", os.path.join(args.cases_of, "chip_smoke.py"))
        cases_of = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cases_of)
    if not torch.cuda.is_available():
        raise SystemExit("time_edge_mlp: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(62)
    wanted = [c for c in args.cases.split(",") if c]
    out = {}
    for what, x, ws, bs, sw in cases_of._mlp_cases(device, gen):
        g = torch.randn(x.shape[0], sw.shape[0],
                        generator=torch.Generator().manual_seed(
                            x.shape[0] * 1000 + sw.shape[0])).to(device)
        if wanted and not any(what.startswith(c) for c in wanted):
            continue
        fwd = M.prepare_edge_mlp_fwd(x, ws, bs, sw, tail=50)
        bwd = M.prepare_edge_mlp_bwd(x, ws, bs, sw, g, tail=50)
        out[what] = {
            k: CS._events_ms(lambda p=p: K.launch_prepared(p), args.reps)
            for k, p in (("edge_mlp_fwd", fwd), ("edge_mlp_bwd", bwd))}
        # device time a launch from a trace of 20 launches (both
        # checkouts' chip_smoke.py have _kernel_trace_us)
        trace = CS._kernel_trace_us(*([fwd, bwd] * 20))
        out[what].update({f"{k}_trace_ms": v / 20 / 1e3
                          for k, v in trace.items()})
        if args.sweep:
            print(f"{what}: {sweep(CS, M, K, x, ws, bs, sw, g, args.reps)}",
                  flush=True)
        if args.detail and hasattr(CS, "_mlp_detail"):
            text, _ = CS._mlp_detail(x, ws, bs, sw, g,
                                     out[what]["edge_mlp_fwd"],
                                     out[what]["edge_mlp_bwd"])
            print(f"{what}: {text}", flush=True)
    print(json.dumps({"label": args.label, "card": card, "times": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
