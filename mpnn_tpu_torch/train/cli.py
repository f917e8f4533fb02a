"""CLI: `python -m mpnn_tpu_torch.train.cli <verb>` (counterpart of
mpnn_tpu/train/cli.py).

Verbs (both run on `cuda` unless --device cpu):
  train    train an experiment on a SMILES CSV through the whole-step
           training kernels: the split of the JAX package's `train` (0.1
           test, then 0.1 of the rest for validation, random_state = the
           seed), per-epoch validation through the eval kernel, one
           checkpoint per epoch in --ckpt-dir, per-step losses and
           per-epoch records in --log; prints one JSON line with the
           history's last record and the test metrics. With --resume it
           restarts from the latest checkpoint in --ckpt-dir, the JAX
           package's or its own, at the next epoch. With --spmm kernel
           the training step takes the decomposed path instead (the JAX
           package's `train --packed --spmm kernel` without --fuse-step):
           the plain model with the step loop in PyTorch ops and a kernel
           for each message sum: the SpMM kernels for the edge-network
           families, the SDDMM kernels for adv_classification and
           att_classification (with the set2vec kernels for their
           readout); every family but ecfp_bilinear, whose message runs
           no kernel in the JAX package either (it raises). For example
           `train --experiment att_classification --data x.csv --spmm
           kernel` on the card, with `--device cpu` the plain versions.
  predict  checkpoint + SMILES CSV → predictions, one JSON line per
           molecule: {"index": i, "pred": x}, or for a classification
           experiment {"index": i, "pred": argmax, "logits": [...]} — the
           serving path, through the whole-step eval kernel.

Experiments: lipo (regression), basic_classification, single_target,
graph_norm_classification, encoded_classification, adv_classification and
att_classification (classification; the CSV's label column holds the
classes, LabelEncoder-encoded over the file as the JAX package does;
single_target then relabels one-vs-rest against class 243, as
test_single_target.py does), and the ECFP
task's encoded_ecfp and ecfp_bilinear (labels: each atom's 16,384 Morgan
bits at radius 3, computed from the SMILES; the CSV's label column is
read and replaced; loss ecfp_mse, `predict` prints each molecule's first
logit, as the JAX package's verb does). ecfp_bilinear takes nf from the
featurized atoms, and its bilinear message is coherent only when the bond
width is nf³: on featurized SMILES it raises, as in the JAX package (the
reference reaches that model only through its Python API).
adv_classification stops training after the first epoch whose summed step
loss is below 0.02. The attention models' set2vec readout normalizes
attention over the whole batch (and att's stateless norm takes batch
statistics), so a molecule's logits depend on the batch it is served in,
as in the reference.

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
    if exp.task == "ecfp":
        return D.load_ecfp_dataset(data_path, exp.mol_col, exp.label_col)
    raise NotImplementedError(f"task {exp.task!r} is still to port")


def apply_experiment_transforms(exp, gs):
    """The experiment's preprocessing of the reference drivers
    (mpnn_tpu/train/cli.py::_apply_experiment_transforms): the class-count
    filter, the one-vs-rest relabeling, the affinity labels. The
    embedding features wait for the pretraining module (ROADMAP)."""
    from mpnn_tpu_torch.graphs.filters import (affinity_labels,
                                               binarize_target,
                                               filter_by_label_count)
    if exp.filter_lower_count is not None or exp.filter_keep_first \
            is not None or exp.filter_upper_count is not None:
        gs, _, _ = filter_by_label_count(
            gs, lower_cutoff=exp.filter_lower_count,
            upper_cutoff=exp.filter_upper_count,
            keep_first=exp.filter_keep_first)
    if exp.binarize_target_class is not None:
        gs = binarize_target(gs, exp.binarize_target_class)
    if exp.affinity_target_class is not None:
        gs = affinity_labels(gs, exp.affinity_target_class)
    if exp.embed_features:
        raise NotImplementedError(
            f"experiment {exp.name!r}: the embedding features need the "
            "pretraining module, still to port (ROADMAP queue 1)")
    return gs


def _n_out_for(exp, gs):
    if exp.task == "classification":
        return int(max(g.label for g in gs)) + 1
    if exp.task == "ecfp":
        return int(np.asarray(gs[0].label).shape[-1])
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
    gs = apply_experiment_transforms(exp, gs)
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
    n_loaded = len(gs)
    gs = apply_experiment_transforms(exp, gs)
    if not gs:
        raise SystemExit(
            f"no graphs left after the experiment's filters (loaded "
            f"{n_loaded}; filters: count>{exp.filter_lower_count}, "
            f"count<{exp.filter_upper_count})")
    net_cfg = _build_net(exp, gs, _n_out_for(exp, gs))
    overrides = {k: v for k, v in (("epochs", args.epochs),
                                   ("batch_size", args.batch_size),
                                   ("ckpt_dir", args.ckpt_dir),
                                   ("log_path", args.log))
                 if v is not None}
    if args.spmm is not None:
        # the JAX CLI has no --fuse-recurrence: its decomposed path runs
        # the step loop in XLA, as this one runs it in PyTorch ops
        # (fuse_recurrence keeps its default, False)
        overrides["fuse_step"] = False
    tcfg = dataclasses.replace(exp.train, **overrides)
    # the reference split: 0.1 test, then 0.1 validation, random_state =
    # the seed (test_lipo.py:143-146)
    train_gs, test_gs = train_test_split(gs, 0.1, tcfg.seed)
    train_gs, val_gs = train_test_split(train_gs, 0.1, tcfg.seed)
    net, history = trainer.train(net_cfg, tcfg, train_gs, val_gs,
                                 resume=args.resume, device=device)
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
    tr.add_argument("--resume", action="store_true",
                    help="restart from the latest ckpt_<epoch>.npz in "
                         "--ckpt-dir (either package's) at the next epoch")
    tr.add_argument("--spmm", choices=["kernel"],
                    help="train through the decomposed path: the SpMM "
                         "(edge-network models) or SDDMM (adv, att) "
                         "kernels for the message sums, the step loop in "
                         "PyTorch ops (default: the whole-step kernels)")
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
