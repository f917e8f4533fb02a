"""How far the first-step parameter gradients of the PyTorch port's
decomposed training path (mpnn_tpu_torch, `train --spmm kernel`) lie from
a float64 run, on a CUDA card, and how much of that moves from run to run:

  * for each model of chip_smoke.py's dec-train and dec-att-train phases
    (lipo with and without the fused recurrence, graph_norm, lipo at afm
    27, adv, att, att at afm 27), on its first shuffled batches and from
    the trainer's initial weights, `--reps` times:
      - the decomposed hooks (float32) against the plain model in float64,
      - the plain model in float32 against float64,
      - the hooks against the plain float32 model (the check before
        float64 was the reference);
  * each as a share of chip_smoke's tolerance (the largest |difference| /
    (atol 1e-5 + rtol 1e-4 · |reference|), each leaf divided by the
    reference's max abs; above 1 fails), with the leaf that sets it;
  * and whether the repeats agreed bit for bit.

    python scripts/dec_grad_noise.py [--reps 24] [--batches 3] [--atomics]

--atomics runs PyTorch's own ops as they run in training (index_add_ and
its kin add with float atomics on the card); without it they run under
torch.use_deterministic_algorithms, as chip_smoke.py's check does. Needs
one CUDA card; builds the kernels first. Prints the card's name and power
limit and one JSON line per model and batch.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from mpnn_tpu_torch import graphs as G  # noqa: E402
from mpnn_tpu_torch.models import zoo  # noqa: E402
from mpnn_tpu_torch.train import experiments  # noqa: E402
from mpnn_tpu_torch.train.split import train_test_split  # noqa: E402
from mpnn_tpu_torch.train.trainer import batch_to_device  # noqa: E402


def _train_split(gs):
    tr, _ = train_test_split(gs, 0.1, 317)
    return train_test_split(tr, 0.1, 317)[0]


def _shape(gs):
    g = gs[0]
    return dict(afm=int(g.afm.shape[-1]), bfm=int(g.bfm.shape[-1]),
                nafm=int(g.nafm.shape[-1]))


def cases():
    """(name, model config, train config with fuse_step off, train
    molecules), as chip_smoke.py's phases build them."""
    out = []
    lipo = experiments.get("lipo")
    for name, csv in (("lipo", C._train_csv(C.TRAIN_ROWS)),
                      ("wide lipo", C._wide_csv("dec_lipo", "mse", "exp"))):
        gs, _ = G.load_number_dataset(csv, "smiles", "exp")
        cfg = zoo.lipo(*_shape(gs).values())
        for rec in ((False, True) if name == "lipo" else (True,)):
            tcfg = dataclasses.replace(lipo.train, fuse_step=False,
                                       fuse_recurrence=rec)
            out.append((name + (" rec" if rec else ""), cfg, tcfg,
                        _train_split(gs)))
    exp = experiments.get("graph_norm_classification")
    gs = G.load_classification_dataset(
        C._ps_csv("dec_graph_norm", C.TRAIN_ROWS), "smiles", "target")[0]
    out.append(("graph_norm", zoo.build(exp.model, **_shape(gs),
                                        n_out=C.PS_CLASSES),
                dataclasses.replace(exp.train, fuse_step=False),
                _train_split(gs)))
    for name, model, csv in (
            ("adv", "adv", C._ps_csv("dec_adv", C.TRAIN_ROWS)),
            ("att", "att", C._ps_csv("dec_att", C.TRAIN_ROWS)),
            ("wide att", "att", C._wide_csv("dec_att", "ce", "target"))):
        exp = experiments.get(C.ATT_MODELS[model][0])
        gs = G.load_classification_dataset(csv, "smiles", "target")[0]
        shape = _shape(gs)
        del shape["nafm"]
        out.append((name, zoo.build(model, **shape, n_out=C.PS_CLASSES),
                    dataclasses.replace(exp.train, fuse_step=False),
                    _train_split(gs)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=24)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--atomics", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dec_grad_noise: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(C.OUT_DIR, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    C.phase_build()
    device = torch.device("cuda", 0)
    for name, cfg, tcfg, tr in cases():
        loader = G.GraphLoader(tr, tcfg.batch_size, shuffle=True,
                               seed=tcfg.seed)
        for bi, b in zip(range(args.batches), loader):
            batch = batch_to_device(b, device)
            rows, first, same = [], None, True
            for _ in range(args.reps):
                dec, p32, exact = C._dec_first_grads(
                    cfg, tcfg, batch, device, deterministic=not args.atomics)
                if first is None:
                    first = (dec, p32)
                same = same and all(
                    torch.equal(x[k], y[k]) for x, y in zip((dec, p32), first)
                    for k in x)
                p64 = {k: v.double() for k, v in p32.items()}
                rows.append([C._grad_distance(cfg, g, ref)[:2] for g, ref in (
                    (dec, exact), (p32, exact), (dec, p64))])
            rec = {"model": name, "batch": bi, "atomics": args.atomics,
                   "reps": args.reps, "bitwise_repeatable": same}
            for j, key in enumerate(("hooks_vs_f64", "plain32_vs_f64",
                                     "hooks_vs_plain32")):
                ms = [r[j][0] for r in rows]
                worst = max(range(len(ms)), key=ms.__getitem__)
                rec[key] = {"max": max(ms), "mean": sum(ms) / len(ms),
                            "over_1": sum(m > 1 for m in ms),
                            "leaf": rows[worst][j][1]}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
