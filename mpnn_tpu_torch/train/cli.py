"""CLI: `python -m mpnn_tpu_torch.train.cli <verb>` (counterpart of
mpnn_tpu/train/cli.py).

Verb:
  predict  checkpoint + SMILES CSV → predictions, one JSON line per
           molecule: {"index": i, "pred": x} — the serving path, through
           the whole-step eval kernel. Runs on `cuda` unless --device cpu.

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
    from mpnn_tpu_torch.graphs.dataset import load_number_dataset
    if exp.task != "regression":
        raise NotImplementedError(f"task {exp.task!r} is still to port")
    return load_number_dataset(data_path, exp.mol_col, exp.label_col)


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
    """{"index": i, "pred": x} for each molecule, in input order."""
    from mpnn_tpu_torch.train.checkpoint import load_checkpoint
    from mpnn_tpu_torch.device import resolve_device
    device = resolve_device(device)
    net_cfg = _build_net(exp, graphs, 1)
    net, _ = load_checkpoint(ckpt, net_cfg, device=device)
    loader = GraphLoader(graphs, batch_size or exp.train.batch_size)
    idx = 0
    for out in predict_batches(net, exp.loss, loader, device):
        for row in out:
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="mpnn_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)

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
