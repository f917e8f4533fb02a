"""CLI: `python -m mpnn_tpu_torch.train.cli <verb>` (counterpart of
mpnn_tpu/train/cli.py).

Verbs (both run on `cuda` unless --device cpu):
  train    train an experiment on a SMILES CSV through the whole-step
           training kernels: the split of the JAX package's `train` (0.1
           test, then 0.1 of the rest for validation, random_state = the
           seed), per-epoch validation through the eval kernel, one
           checkpoint per epoch in --ckpt-dir, per-step losses and
           per-epoch records in --log; prints one JSON line with the
           history's last record and the test metrics.
  predict  checkpoint + SMILES CSV → predictions, one JSON line per
           molecule: {"index": i, "pred": x}, or for a classification
           experiment {"index": i, "pred": argmax, "logits": [...]} — the
           serving path, through the whole-step eval kernel.

Experiments: lipo (regression), graph_norm_classification,
encoded_classification and adv_classification (classification; the CSV's
label column holds the classes, LabelEncoder-encoded over the file as the
JAX package does). adv_classification stops training after the first
epoch whose summed step loss is below 0.02; its set2vec readout
normalizes attention over the whole batch, so a molecule's logits depend
on the batch it is served in, as in the reference.

The checkpoint is the .npz either package writes (train/checkpoint.py).
"""

from __future__ import annotations

import argparse
import json
from typing import Iterator, List

import numpy as np

from mpnn_tpu_torch.graphs.dataloader import GraphLoader
from mpnn_tpu_torch.graphs.graph import MolGraph


def _load_for(exp, data_path):
    from mpnn_tpu_torch.graphs import dataset as D
    if exp.task == "classification":
        gs, _n, _labels, ge = D.load_classification_dataset(
            data_path, exp.mol_col, exp.label_col)
        return gs, ge
    if exp.task == "regression":
        return D.load_number_dataset(data_path, exp.mol_col, exp.label_col)
    raise NotImplementedError(f"task {exp.task!r} is still to port")


def _n_out_for(exp, gs):
    if exp.task == "classification":
        return int(max(g.label for g in gs)) + 1
    return 1


def _build_net(exp, gs, n_out):
    from mpnn_tpu_torch.models import build
    # widths from the encoded graphs themselves
    return build(exp.model, afm=int(gs[0].afm.shape[-1]),
                 bfm=int(gs[0].bfm.shape[-1]),
                 nafm=int(gs[0].nafm.shape[-1]), n_out=n_out)


def predict_batches(net, loss_kind: str, loader: GraphLoader, device
                    ) -> Iterator[np.ndarray]:
    """One (G, n_out) numpy array per request batch, through the serving
    path (the fused eval kernel on `device`)."""
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch)
    for batch in loader:
        step = eval_step_for_batch(net.cfg, loss_kind, batch)
        _, out = step(net, batch_to_device(batch, device))
        yield out.cpu().numpy()


def predict_records(exp, graphs: List[MolGraph], ckpt: str, *,
                    batch_size=None, device=None) -> Iterator[dict]:
    """{"index": i, "pred": x} for each molecule, in input order; for a
    ce experiment {"index": i, "pred": argmax, "logits": [...]}."""
    from mpnn_tpu_torch.train.checkpoint import load_checkpoint
    from mpnn_tpu_torch.device import resolve_device
    device = resolve_device(device)
    net_cfg = _build_net(exp, graphs, _n_out_for(exp, graphs))
    net, _ = load_checkpoint(ckpt, net_cfg, device=device)
    loader = GraphLoader(graphs, batch_size or exp.train.batch_size)
    idx = 0
    for out in predict_batches(net, exp.loss, loader, device):
        for row in out:
            if exp.loss == "ce":
                yield {"index": idx, "pred": int(row.argmax()),
                       "logits": row.tolist()}
            else:
                yield {"index": idx, "pred": float(row.reshape(-1)[0])}
            idx += 1


def cmd_predict(args):
    """Inference: checkpoint + SMILES CSV → predictions (JSON lines)."""
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.device import resolve_device
    exp = experiments.get(args.experiment)
    device = resolve_device(args.device)      # before the featurization
    gs, _ge = _load_for(exp, args.data)
    for rec in predict_records(exp, gs, args.ckpt,
                               batch_size=args.batch_size, device=device):
        print(json.dumps(rec))


def cmd_train(args):
    """Train an experiment; one JSON line of results."""
    import dataclasses
    from mpnn_tpu_torch.device import resolve_device
    from mpnn_tpu_torch.train import experiments, trainer
    from mpnn_tpu_torch.train.split import train_test_split
    exp = experiments.get(args.experiment)
    device = resolve_device(args.device)      # before the featurization
    gs, _ge = _load_for(exp, args.data)
    net_cfg = _build_net(exp, gs, _n_out_for(exp, gs))
    overrides = {k: v for k, v in (("epochs", args.epochs),
                                   ("batch_size", args.batch_size),
                                   ("ckpt_dir", args.ckpt_dir),
                                   ("log_path", args.log))
                 if v is not None}
    tcfg = dataclasses.replace(exp.train, **overrides)
    # the reference split: 0.1 test, then 0.1 validation, random_state =
    # the seed (test_lipo.py:143-146)
    train_gs, test_gs = train_test_split(gs, 0.1, tcfg.seed)
    train_gs, val_gs = train_test_split(train_gs, 0.1, tcfg.seed)
    net, history = trainer.train(net_cfg, tcfg, train_gs, val_gs,
                                 device=device)
    test = trainer.evaluate(net, GraphLoader(test_gs, tcfg.batch_size),
                            exp.loss, tcfg.metric_average, device=device)
    print(json.dumps({"experiment": exp.name, "epochs": len(history),
                      "last": history[-1] if history else None,
                      "test": test}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="mpnn_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--experiment", required=True)
    tr.add_argument("--data", required=True)
    tr.add_argument("--epochs", type=int)
    tr.add_argument("--batch-size", type=int)
    tr.add_argument("--ckpt-dir")
    tr.add_argument("--log", help="append every step's loss and every "
                                  "epoch's record as JSON lines")
    tr.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the CUDA training kernels, default) or cpu "
                         "(their plain PyTorch versions)")
    tr.set_defaults(fn=cmd_train)

    pd = sub.add_parser("predict")
    pd.add_argument("--experiment", required=True)
    pd.add_argument("--data", required=True)
    pd.add_argument("--ckpt", required=True)
    pd.add_argument("--batch-size", type=int)
    pd.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (the CUDA eval kernel, default) or cpu (its "
                         "plain PyTorch version)")
    pd.set_defaults(fn=cmd_predict)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
