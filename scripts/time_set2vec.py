"""Time the set2vec kernels of the checkout in the working directory, so
that two commits can be held against each other on one card:

    cd <checkout> && python <this repo>/scripts/time_set2vec.py --label L

imports that checkout's mpnn_tpu_torch and chip_smoke (bench.py's SMILES
and their packed batch), builds its set2vec kernels and times, with CUDA
events over repeated launches, the serving forward, the training forward
(with the stash) and the backward of the reference's 100 steps with the
batch-global softmax, at adv's widths (w 14) at batch 16 and 1024 and at
w 54 at batch 16 and 2048, on seeded random x and leaves. Run it on both commits
in turns (parent, change, change, parent); --cases takes a subset (a
checkout that refuses a case cannot run it). Prints one JSON line:
{"label", "card", "times": {case: {kernel: ms}}}; with --detail, first a
line per case with its route, the empty-step floor and a clock64
breakdown of a step (chip_smoke.py::_s2v_time_line, where the checkout
has it).
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

CASES = (("b16", 16, 14), ("b1024", 1024, 14), ("b16-w54", 16, 54),
         ("b2048-w54", 2048, 54))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES),
                    help="comma-separated case names")
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as CS
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import set2vec as S
    from mpnn_tpu_torch.train.trainer import batch_to_device
    if not torch.cuda.is_available():
        raise SystemExit("time_set2vec: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(12)
    out = {}
    for name, bs, w in CASES:
        if name not in args.cases.split(","):
            continue
        smiles = (CS.SMILES * -(-bs // len(CS.SMILES)))[:bs]
        tb = batch_to_device(CS._batch(smiles, bs), device)
        mask, ng = tb["node_mask"], tb["node_graph"]
        gnp = tb["plan_graph_node_ptr"]
        b = (2 * w) ** -0.5
        u = lambda *s, b=b: ((torch.rand(*s, generator=gen) * 2 - 1)
                             * b).to(device)
        leaves = [u(2 * w, w) for _ in range(4)] + [u(1, w) for _ in
                                                    range(4)] + [
            u(w, w, b=w ** -0.5), u(w, 1, b=w ** -0.5)]
        x = (torch.randn(mask.shape[0], w, generator=gen).to(device)
             * mask).contiguous()
        meta = S.S2vMeta(100, True)
        serve = S.prepare_set2vec_fwd(leaves, x, mask, ng, gnp, meta,
                                      stash=False)
        train = S.prepare_set2vec_fwd(leaves, x, mask, ng, gnp, meta,
                                      stash=True)
        m, carry, att = K.launch_prepared(train)
        gm = torch.randn(m.shape, generator=gen).to(device)
        back = S.prepare_set2vec_bwd(leaves, x, gnp, carry, att, gm, meta)
        out[name] = {
            k: CS._events_ms(lambda p=p: K.launch_prepared(p), args.reps)
            for k, p in (("set2vec_fwd", serve),
                         ("set2vec_fwd_stash", train),
                         ("set2vec_bwd", back))}
        if args.detail and hasattr(CS, "_s2v_time_line"):
            print(CS._s2v_time_line(name, leaves, x, mask, ng, gnp, meta,
                                    device, out[name], {}), flush=True)
    print(json.dumps({"label": args.label, "card": card, "times": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
