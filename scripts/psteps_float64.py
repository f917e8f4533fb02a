"""How far the per-step family's training kernels lie from float64, and
which kernel puts them there, on the 4,000-node graph of
tests/test_torch_gpu.py::test_cuda_psteps_bwd_against_float64:

    python scripts/psteps_float64.py [--pairs bn1d/bn1d,none/bn1d,...]

For each norm pair, each output and gradient leaf's distance from a
float64 run of the plain version (scaled by that answer's max abs), for:
the two kernels end to end ("kernels"), the plain float32 version
("plain"), the backward kernel on the float64 forward's residuals rounded
to float32 ("bwd on exact"), and the backward kernel on the plain float32
forward's residuals ("bwd on plain"); and each stash slot's and the
statistics' distance from the float64 forward for the forward kernel and
the plain float32 forward. A leaf where "kernels" passes max(1e-5,
"plain") is the test's failure; "bwd on exact" tells the backward's own
share from the forward stash's. Needs the card, or with --emulate runs
the kernels on the CPU through the CUDA stand-in (scripts/cuda_emu/; both
launches on a cluster of 8, within the stand-in's threads; ~5 min a pair):
the plain float32 version then runs on the CPU too. Prints one JSON line
a pair and the card's name and power limit.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"), os.path.join(HERE,
                                                                "cuda_emu")]

import test_torch_gpu as T                                     # noqa: E402
from mpnn_tpu_torch.kernels import fused_psteps as P           # noqa: E402
from mpnn_tpu_torch.kernels import fused_step as K             # noqa: E402


def _leaves_of(dh0, dw, k, f, od, steps):
    g = P.split_grads(dw, k, f, od, steps)
    return {"amat": g["amat"], "a0": g["a0"], "mbias": g["mbias"], "h0": dh0,
            **{f"gru/{n}": g[n] for n in ("w_ih", "w_hh", "b_ih", "b_hh")},
            **{f"{s}{i}/{n}": g[f"{s}_{n[0]}"][i] for s in ("ma", "bn")
               for i in range(steps) for n in ("weight", "bias")},
            **{f"ro/{s}/{n}": g[f"ro_{s}{n}"] for s in ("i", "j")
               for n in ("w", "b")}}


def _dist(x, e):
    return float(((x.double() - e) / e.abs().max().clamp_min(1e-30))
                 .abs().max())


def pair(msg_norm, state_norm, steps=3, device="cuda"):
    rng = np.random.RandomState(4008)
    c, leaves = T._ps_problem(rng, 4, big=4000, device=device)
    cw = torch.as_tensor(rng.randn(4, 16).astype(np.float32), device=device)
    kw = dict(steps=steps, msg_norm=msg_norm, state_norm=state_norm)
    exact = T.float64_ps_step_and_grads(c, cw, **kw)
    want = T.ps_step_and_grads(P.fused_psteps_reference, c, leaves, cw, **kw)
    got = T.ps_step_and_grads(P.fused_psteps, c, leaves, cw, bwd="whole",
                              **kw)
    d = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
         for k, v in c.items()}
    det = lambda x: ({k: det(v) for k, v in x.items()}
                     if isinstance(x, dict) else [det(v) for v in x]
                     if isinstance(x, list) else x.detach())
    weights, meta = P.flat_weights(
        d["amat"], d["a0"], d["mbias"], det(d["gru"]), det(d["ma_bns"]),
        det(d["bns"]), det(d["ro"]), d["h0"], **kw)
    batch = (d["mask"], d["node_graph"], d["labels"], d["gmask"], d["vid"],
             d["src"], d["dst"], d["plan"])
    with torch.no_grad():
        r64 = P._reference_residuals(
            [(n, t.double()) for n, t in weights], d["h0"].double(),
            d["mask"].double(), d["node_graph"], d["labels"].double(),
            d["gmask"].double(), *batch[4:], meta)
        r32 = P._reference_residuals(weights, d["h0"], *batch, meta)
        rk = P.forward_residuals(weights, d["h0"], *batch, meta)
    k, f, od = d["amat"].shape[1], d["h0"].shape[1], cw.shape[1]

    def bwd_on(res):
        _, out, stats, htil = res
        dh0, dw = K.launch_prepared(P.prepare_fused_psteps_bwd(
            weights, d["h0"], d["labels"], d["gmask"], out.float(), cw,
            torch.full((1,), 1.3, device=device), htil.float(),
            stats.float(), d["node_graph"], d["vid"], d["src"], d["dst"],
            d["plan"], meta))
        return _leaves_of(dh0, dw, k, f, od, steps)
    on_exact, on_plain = bwd_on(r64), bwd_on(r32)
    dist = T.exactness(got, want, exact, msg_norm)
    leaves_out = {}
    for name, (dk, dp) in dist.items():
        row = {"kernels": dk, "plain": dp}
        if name in on_exact:
            row["bwd on exact"] = _dist(on_exact[name], exact[4][name])
            row["bwd on plain"] = _dist(on_plain[name], exact[4][name])
        row["fails"] = dk > max(T.ATOL, dp)
        leaves_out[name] = row
    stash = {}
    for s in range(2 * steps):
        stash[f"htil {s}"] = {"kernel": _dist(rk[3][s], r64[3][s]),
                              "plain": _dist(r32[3][s], r64[3][s])}
        stash[f"stats {s}"] = {"kernel": _dist(rk[2][s], r64[2][s]),
                               "plain": _dist(r32[2][s], r64[2][s])}
    worst = max(leaves_out.items(), key=lambda kv: kv[1]["kernels"])
    return {"pair": f"{msg_norm}/{state_norm}",
            "failing": {n: r for n, r in leaves_out.items() if r["fails"]},
            "worst leaf": worst, "stash": stash}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", default=",".join(
        f"{m}/{s}" for m, s in T.PS_NORMS))
    ap.add_argument("--emulate", action="store_true")
    args = ap.parse_args(argv)
    device, routes = "cuda", contextlib.nullcontext()
    if args.emulate:
        import chip_smoke as CS
        import emu
        emu.build(["fused_psteps_fwd:mpnn_psfwd::FwdArgs",
                   "fused_psteps_bwd:PsBwdArgs"])
        emu.emulate(K, P)
        device, routes = "cpu", contextlib.ExitStack()
        routes.enter_context(CS._ps_route("cluster 8"))
        routes.enter_context(CS._ps_fwd_route("cluster 8"))
        print("emulated", flush=True)
    elif not torch.cuda.is_available():
        raise SystemExit("psteps_float64: no CUDA device")
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    with routes:
        for p in args.pairs.split(","):
            m, s = p.split("/")
            print(json.dumps(pair(m, s, device=device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
