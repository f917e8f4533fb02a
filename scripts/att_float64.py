"""How far the adv model's message + GRU kernels (csrc/fused_att_fwd.cu,
csrc/fused_att_bwd.cu) lie from float64 on the 4,000-node graph of
tests/test_torch_gpu.py::test_cuda_att_bwd_against_float64 (one 4,000-node
graph among small ones, adv's widths, the 'att' correction on):

    cd <checkout> && python <this repo>/scripts/att_float64.py [--emulate]
        [--route R]

For the forward's outputs h and msgs, and for each gradient leaf, the
distance from a float64 run of the plain version (scaled by that answer's
max abs), for the kernels ("kernels"), the plain float32 version
("plain"), and the backward kernel on the float64 forward's messages
rounded to float32 ("bwd on exact": the backward's own share). A leaf
where "kernels" passes max(1e-5, "plain") fails the test. Needs the card,
or with --emulate runs the kernels on the CPU through the CUDA stand-in
(scripts/cuda_emu/; ~2 min); `--route` forces the backward's route
(chip_smoke.py::_adv_bwd_route). Prints one JSON line and, on the card,
the card's name and power limit.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

# the checkout in the working directory (as scripts/time_att.py: another
# commit's kernels are measured from its own checkout)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"), os.path.join(HERE,
                                                                "cuda_emu")]

import test_torch_gpu as T                                     # noqa: E402
from mpnn_tpu_torch.kernels import fused_att as A              # noqa: E402
from mpnn_tpu_torch.kernels import fused_step as K             # noqa: E402

LEAVES = ("aprime", "a0", "qv", "q0", "wh", "h0", "gru/w_ih", "gru/w_hh",
          "gru/b_ih", "gru/b_hh")


def problem(device):
    """The test's batch and weights: (args minus the leaves, {leaf:
    float32 tensor}, cotangent)."""
    rng = np.random.RandomState(4015)
    (_, _, _, h0, mask, ng, gru, _, _, _, _, _, vid, src, dst,
     plan) = T._problem(rng, g=4, f=7, od=4, k=8, big=4000, device=device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    w = {"aprime": t(rng.randn(8, 7, 7) * 0.3), "a0": t(rng.randn(7, 7) * 0.3),
         "qv": t(rng.randn(8, 7)), "q0": t(rng.randn(7)),
         "wh": t(rng.randn(7, 7) * 0.5), "h0": h0,
         **{f"gru/{n}": v for n, v in gru.items()}}
    cw = t(rng.randn(*h0.shape))
    return (mask, ng, vid, src, dst, plan), w, cw


def run(fn, batch, w, cw, dtype):
    """fn's output and every leaf's gradient of Σ out·cw, in float64."""
    mask, ng, vid, src, dst, plan = batch
    lv = {k: v.detach().to(dtype).requires_grad_(True) for k, v in w.items()}
    out = fn(lv["aprime"], lv["a0"], lv["qv"], lv["q0"], lv["wh"], lv["h0"],
             mask.to(dtype), ng,
             {n: lv[f"gru/{n}"] for n in ("w_ih", "w_hh", "b_ih", "b_hh")},
             vid, src, dst, plan, with_corr=True)
    gr = torch.autograd.grad((out * cw.to(dtype)).sum(), list(lv.values()),
                             allow_unused=True)
    return out.detach().double(), {
        k: (torch.zeros_like(v) if g_ is None else g_).double()
        for (k, v), g_ in zip(lv.items(), gr)}


def dist(x, e):
    return float(((x.double() - e) / e.abs().max().clamp_min(1e-30))
                 .abs().max())


def measure(device):
    batch, w, cw = problem(device)
    mask, ng, vid, src, dst, plan = batch
    got = run(A.fused_att, batch, w, cw, torch.float32)
    again = run(A.fused_att, batch, w, cw, torch.float32)
    plain = run(A.fused_att_reference, batch, w, cw, torch.float32)
    exact = run(A.fused_att_reference, batch, w, cw, torch.float64)
    same = all(torch.equal(got[1][k], again[1][k]) for k in got[1])
    g = int(plan.graph_node_ptr.shape[0]) - 1
    d = {k: v.detach() for k, v in w.items()}

    def msgs(dtype):
        return A.att_messages(
            d["aprime"].to(dtype), d["a0"].to(dtype), d["qv"].to(dtype),
            d["q0"].to(dtype), d["wh"].to(dtype), d["h0"].to(dtype),
            mask.to(dtype), ng, vid, src, dst, g, with_corr=True)
    weights = [(n, d[n] if n in d else d[f"gru/{n}"])
               for n in A._GRAD_LEAVES]
    with torch.no_grad():
        _, mk = K.launch_prepared(A.prepare_fused_att_fwd(
            weights, d["h0"], mask, ng, vid, src, dst, plan,
            with_corr=True, write_msgs=True))
        m64, m32 = msgs(torch.float64), msgs(torch.float32)
        dh0, dw = K.launch_prepared(A.prepare_fused_att_bwd(
            weights, d["h0"], m64.float().contiguous(), cw, vid, src, dst,
            plan, with_corr=True))
    sg = A.split_grads(dw, 8, 7)
    on_exact = {**{k: sg[k] for k in ("aprime", "a0", "qv", "q0", "wh")},
                "h0": dh0, **{f"gru/{n}": sg[n] for n in
                              ("w_ih", "w_hh", "b_ih", "b_hh")}}
    rows = {"h": {"kernels": dist(got[0], exact[0]),
                  "plain": dist(plain[0], exact[0])},
            "msgs": {"kernels": dist(mk, m64), "plain": dist(m32, m64)}}
    for k in LEAVES:
        rows[k] = {"kernels": dist(got[1][k], exact[1][k]),
                   "plain": dist(plain[1][k], exact[1][k]),
                   "bwd on exact": dist(on_exact[k], exact[1][k])}
    for r in rows.values():
        r["fails"] = r["kernels"] > max(T.ATOL, r["plain"])
    return {"graph": "4 graphs, one of 4,000 nodes, f 7, K 8, with_corr",
            "same bits twice": same,
            "failing": sorted(k for k, r in rows.items() if r["fails"]),
            "rows": rows}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--emulate", action="store_true")
    ap.add_argument("--route", default=None)
    args = ap.parse_args(argv)
    device = "cuda"
    if args.emulate:
        import emu
        emu.build(["fused_att_fwd:FwdArgs", "fused_att_bwd:BwdArgs"])
        emu.emulate(A)
        device = "cpu"
        print("emulated", flush=True)
    elif not torch.cuda.is_available():
        raise SystemExit("att_float64: no CUDA device")
    else:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    route = contextlib.nullcontext()
    if args.route is not None:
        import chip_smoke as CS
        route = CS._adv_bwd_route(args.route)
    with route:
        print(json.dumps(measure(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
