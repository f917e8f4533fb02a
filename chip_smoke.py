#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. device  — nvidia-smi name and power limit, torch/CUDA versions;
  2. build   — nvcc of every kernel source in mpnn_tpu_torch/csrc/ (one
               process each, started together), with ptxas' register /
               shared-memory / spill report;
  3. kernel-check — each CUDA kernel against its plain PyTorch version on
               the card: flagship lipo widths at batch 1024 for every
               msg/state norm pair in {bn1d, none}², and a ragged batch
               with padded edges and single-atom molecules
               (rtol 1e-4, atol 1e-5: float32 sums in other orders); the
               training kernels with nonzero loss and `out` cotangents,
               each gradient leaf scaled by its max abs;
  4. serve   — the `predict` verb from SMILES (bench.py's ten molecules,
               repeated) at batch 16 and 1024 with a checkpoint built from
               a seeded torch.Generator; launch counts read around it;
               predictions checked finite and against the plain path;
  5. times   — request latency (host clock ending in a device sync) and
               the eval kernel's time (CUDA events) beside its bound and
               its plain version's time;
  6. profile — torch.profiler trace of one batch-1024 request: device
               busy time, the kernel's share and the device idle share;
  7. train   — the `train` verb at batch 16 for 2 epochs on 640 of
               bench.py's molecules (validation split, plateau schedule,
               a checkpoint per epoch); launch counts read around it (one
               forward and one backward launch per step); the first 3
               steps' losses against the plain path on the card (rtol
               1e-3); then `predict` from the checkpoint it wrote;
  8. train-times — train-step latency at batch 16 and 1024, and each
               training kernel's time beside its bound and its plain
               version's time;
  9. train-profile — torch.profiler trace of one batch-1024 train step;
 10. ps-kernel-check — the per-step family's three kernels against their
               plain versions on the card (rtol 1e-4, atol 1e-5; each
               gradient leaf scaled by its max abs; cotangents
               1.3·loss + Σ out·c): encoded widths (f 8, od 16, T 3) at
               batch 1024 for all six msg × state norm pairs, graph_norm's
               widths (f 7, od 28), a ragged batch, and one forward and
               backward past 28,672 padded node slots (2,560 molecules);
 11. ps-serve  — `predict` of graph_norm_classification and
               encoded_classification from SMILES at batch 16 and 1024,
               checkpoints built from a seeded torch.Generator; one eval
               launch per request; logits against the plain path;
 12. ps-train  — the `train` verb of both experiments for 2 epochs on a
               4-class CSV of bench.py's molecules; one forward and one
               backward launch per step; the first 3 losses against the
               plain path (rtol 1e-3); then `predict` from a checkpoint;
 13. ps-times  — request and train-step latency of the encoded model at
               batch 128 and 1024, each per-step kernel's time beside its
               bound and its plain version's, and the b1024 train step's
               device idle share;
 14. att-kernel-check — the attention model's four kernels (fused_att
               fwd/bwd, set2vec fwd/bwd) against their plain versions on
               the card (rtol 1e-4, atol 1e-5; gradient leaves scaled by
               their max abs): adv widths (f 7, w 14) at batch 1024 and
               T 100, both aggregations (att, adj), both softmax modes,
               T 3, and a ragged batch with a padded graph slot;
 15. att-serve — `predict --experiment adv_classification` at batch 16
               and 1024 from a seeded checkpoint: one fused_att_fwd and one
               set2vec_fwd launch per request, logits against the plain
               path on the same batches;
 16. att-train — its `train` verb, 2 epochs at batch 16: one launch of
               each forward and backward per step, the first 3 losses
               against the plain path (rtol 1e-3), the first step's logits
               and every parameter gradient against it (each divided by
               its max abs; rtol 1e-4, atol 1e-5), `predict` from the
               checkpoint it wrote;
 17. att-times — request and train-step latency at batch 16 and 1024,
               each kernel's time beside its bound and its plain version's,
               and the b1024 train step's device idle share.
Then the `kernels` JSON line, and last {"ok": true, "device": {...}}.
Files it writes go to $MPNN_SMOKE_OUT (default ./smoke_out/).
Any failure exits non-zero without the last line. Needs one card and
imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# build logs, the profile table, the CSVs and checkpoint the run serves
OUT_DIR = os.environ.get("MPNN_SMOKE_OUT", os.path.join(REPO, "smoke_out"))

# bench.py's ten molecules
SMILES = [
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(=O)Oc1ccccc1C(=O)O", "c1ccc2c(c1)cccc2O",
    "CCN(CC)CCNC(=O)c1ccc(N)cc1", "NC(=O)c1ccccc1", "OC(=O)c1ccccc1O",
    "c1ccncc1CCO", "CC(C)(C)NCC(O)c1ccc(O)c(CO)c1",
    "ClC1=CC=CC=C1C(=O)NCCN",
]
RTOL, ATOL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet, at the full 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _within(got, want):
    import torch
    d = (got - want).abs()
    ok = bool((d <= ATOL + RTOL * want.abs()).all())
    rel = float((d / want.abs().clamp_min(1e-30)).max())
    return ok, float(d.max()), rel


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "not measured"
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | device_count {torch.cuda.device_count()}"
          f" | kind {torch.cuda.get_device_name(0)}", flush=True)
    return card


def phase_build():
    from mpnn_tpu_torch.kernels import build
    from mpnn_tpu_torch.kernels import fused_step as K
    t0 = time.perf_counter()
    secs = build.build_all(force=True)
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    report = []
    for name, log in build.BUILD_LOG.items():
        with open(os.path.join(OUT_DIR, f"build_{name}.log"), "w") as f:
            f.write(log)
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                t = re.search(r"Li(\d+)ELi(\d+)E", m.group(1))
                k = re.search(r"\d((?:fused|set2vec)_[a-z_]+_kernel)[EI]",
                              m.group(1))
                w = re.search(r"_kernelILi(\d+)EE", m.group(1))
                entry = (f"<{t.group(1)},{t.group(2)}>" if t
                         else f" {k.group(1)}" + (f"<{w.group(1)}>" if w
                                                   else "")
                         if k else m.group(1))
                spill = "?"
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                smem = re.search(r"(\d+) bytes smem", line)
                report.append(f"{name}{entry} {m.group(1)} regs, "
                              f"{smem.group(1) if smem else 0} B static "
                              f"smem, spill {spill} B")
    if not report:
        raise RuntimeError("no ptxas report in the build log")
    # the kernels' weights live in dynamic shared memory, which ptxas does
    # not see: the launch's size at the flagship vocab of 16 (and T = 6)
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import set2vec as S
    dyn = (f"fused_eval {K._lib().mpnn_fused_eval_smem_bytes(16)} B, "
           f"fused_step_fwd "
           f"{K._lib('fused_step_fwd').mpnn_fused_step_fwd_smem_bytes(16, 6)}"
           f" B, fused_step_bwd "
           f"{K._lib('fused_step_bwd').mpnn_fused_step_bwd_smem_bytes(16, 6)}"
           f" B (T 6); " + ", ".join(
               f"{n} {getattr(P._lib(n), f'mpnn_{n}_smem_bytes')(3)} B"
               for n in ("fused_psteps_eval", "fused_psteps_fwd",
                         "fused_psteps_bwd"))
           + " (T 3; their A tables stay in device memory, any K); "
           + ", ".join(
               f"{n} {getattr(A._lib(n), f'mpnn_{n}_smem_bytes')(16)} B"
               for n in ("fused_att_fwd", "fused_att_bwd"))
           + " (K 16); " + ", ".join(
               f"{n} {getattr(S._lib(n), f'mpnn_{n}_smem_bytes')(14)} B"
               for n in ("set2vec_fwd", "set2vec_bwd")) + " (w 14)")
    print(f"build: {wall:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())});"
          f" ptxas: {'; '.join(report)}; dynamic smem per block at K=16: "
          f"{dyn}", flush=True)


def _random_weights(f, od, k, gen, device):
    import torch

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)
    amat = r(k, f, f, s=0.2)
    amat[0] = 0.0                    # vocab id 0 = the zero row → A = 0
    w = dict(amat=amat, a0=r(f, f, s=0.1), mbias=r(f, s=0.1),
             gru={"w_ih": r(f, 3 * f, s=0.3), "w_hh": r(f, 3 * f, s=0.3),
                  "b_ih": r(3 * f, s=0.1), "b_hh": r(3 * f, s=0.1)},
             ro={"i": {"w": r(2 * f, od, s=0.3), "b": r(od, s=0.1)},
                 "j": {"w": r(2 * f, od, s=0.3), "b": r(od, s=0.1)}})
    for key in ("ma", "bn"):
        w[key] = {"weight": 1 + r(f, s=0.2), "bias": r(f, s=0.2)}
        w[key + "_state"] = {
            "running_mean": r(f, s=0.3),
            "running_var": (0.3 + torch.rand(f, generator=gen)).to(device)}
    return w


def _kernel_args(tb, w):
    """fused_eval's positional arguments for a device batch `tb` whose
    node features (+ nafm) are the kernel's h0."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    mask = tb["node_mask"]
    h0 = (torch.cat([tb["node_feats"], tb["node_nafm"]], -1) * mask)
    return (w["amat"], w["a0"], w["mbias"], h0.contiguous(), mask,
            tb["node_graph"], w["gru"], w["ma"], w["ma_state"], w["bn"],
            w["bn_state"], w["ro"], tb["edge_vid"], tb["edge_src"],
            tb["edge_dst"], plan_from_batch(tb))


def _batch(smiles, batch_size):
    from mpnn_tpu_torch import graphs as G
    gs = G.generate_molgraphs(smiles, [0.0] * len(smiles))
    gs, _ = G.encode_molgraphs(gs)
    return next(iter(G.GraphLoader(gs, batch_size, collate="packed")))


def phase_kernel_check(device):
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(1)
    flag = batch_to_device(_batch((SMILES * 103)[:1024], 1024), device)
    ragged_smiles = SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
    ragged = batch_to_device(_batch(ragged_smiles, len(ragged_smiles)),
                             device)
    results, worst = [], 0.0
    cases = [(flag, mn, sn) for mn in ("bn1d", "none")
             for sn in ("bn1d", "none")] + [(ragged, "bn1d", "bn1d")]
    failed = []
    for i, (tb, mn, sn) in enumerate(cases):
        k = int(tb["edge_vfirst"].shape[0])
        f = tb["node_feats"].shape[1] + tb["node_nafm"].shape[1]
        w = _random_weights(f, 14, k, gen, device)
        args = _kernel_args(tb, w)
        got = K.fused_eval(*args, steps=6, msg_norm=mn, state_norm=sn)
        torch.cuda.synchronize()
        want = K.fused_eval_reference(*args, steps=6, msg_norm=mn,
                                      state_norm=sn)
        ok, mabs, mrel = _within(got, want)
        worst = max(worst, mabs)
        what = ("ragged" if tb is ragged else "batch1024") + f" {mn}/{sn}"
        results.append(f"{what} G={got.shape[0]} f={f} max_abs={mabs:.3e} "
                       f"max_rel={mrel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok or not torch.isfinite(got).all():
            failed.append(what)
    e_real = int(ragged["edge_mask"].sum())
    print(f"kernel-check: fused_eval vs fused_eval_reference (rtol {RTOL}, "
          f"atol {ATOL}; ragged: {e_real} real of "
          f"{ragged['edge_src'].shape[0]} edges, single-atom graphs): "
          + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{failed}")
    worst_fwd, worst_bwd, results = 0.0, 0.0, []
    for tb, mn, sn in cases:
        k = int(tb["edge_vfirst"].shape[0])
        f = tb["node_feats"].shape[1] + tb["node_nafm"].shape[1]
        w = _random_weights(f, 14, k, gen, device)
        args, leaves = _step_args(tb, w, gen)
        g = int(tb["graph_mask"].shape[0])
        cw = torch.randn(g, 14, generator=gen).to(device)
        kw = dict(steps=6, msg_norm=mn, state_norm=sn)
        got = _step_and_grads(K.fused_step, args, leaves, cw, kw)
        torch.cuda.synchronize()
        want = _step_and_grads(K.fused_step_reference, args, leaves, cw, kw)
        ok_f, err_f, ok_b, err_b = _step_errors(got, want, mn)
        worst_fwd, worst_bwd = max(worst_fwd, err_f), max(worst_bwd, err_b)
        what = ("ragged" if tb is ragged else "batch1024") + f" {mn}/{sn}"
        results.append(f"{what} fwd max_abs={err_f:.3e} "
                       f"bwd max_scaled={err_b:.3e} "
                       f"{'ok' if ok_f and ok_b else 'FAIL'}")
        if not (ok_f and ok_b):
            failed.append(what)
    print(f"kernel-check: fused_step_fwd vs fused_step_reference, "
          f"fused_step_bwd vs autograd through it (T 6, cotangents "
          f"1.3·loss + Σ out·c; forward rtol {RTOL} atol {ATOL}; each "
          f"gradient leaf divided by its max abs, rtol {RTOL} atol {ATOL}; "
          f"message_bias under the message bn1d within {ATOL}·max|dA0|): "
          + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"training kernels disagree with their plain "
                           f"version: {failed}")
    return {"fused_eval": worst, "fused_step_fwd": worst_fwd,
            "fused_step_bwd": worst_bwd}


def _step_args(tb, w, gen):
    """fused_step's positional arguments for a device batch `tb` with the
    weights `w` made leaves, random labels and one padded graph slot; and
    the leaves in fused_step's gradient order."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    mask = tb["node_mask"]
    h0 = (torch.cat([tb["node_feats"], tb["node_nafm"]], -1) * mask)
    h0 = h0.contiguous().requires_grad_()
    leaves = [w["amat"], w["a0"], w["mbias"], h0, *w["gru"].values(),
              *w["ma"].values(), *w["bn"].values(), w["ro"]["i"]["w"],
              w["ro"]["i"]["b"], w["ro"]["j"]["w"], w["ro"]["j"]["b"]]
    for x in leaves:
        x.requires_grad_()
    g = int(tb["graph_mask"].shape[0])
    labels = torch.randn(g, generator=gen).to(mask.device)
    gmask = torch.ones(g, device=mask.device)
    gmask[-1] = 0.0
    return ((w["amat"], w["a0"], w["mbias"], h0, mask, tb["node_graph"],
             w["gru"], w["ma"], w["bn"], w["ro"], labels, gmask,
             tb["edge_vid"], tb["edge_src"], tb["edge_dst"],
             plan_from_batch(tb)), leaves)


def _step_and_grads(fn, args, leaves, cw, kw):
    """fn's (loss, out, every slot's stats) and the gradient of
    1.3·loss + Σ out·cw in every leaf (zeros for a leaf the norm modes
    leave out)."""
    import torch
    loss, out, ma, steps = fn(*args, **kw)
    grads = torch.autograd.grad(1.3 * loss + (out * cw).sum(), leaves,
                                allow_unused=True)
    # the shared family's one message-norm pair, or the per-step T pairs
    stats = [x for pair in [*(ma if isinstance(ma, list) else [ma]),
                            *steps] for x in pair]
    return ([loss.detach().reshape(1), out.detach(), *stats],
            [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(leaves, grads)])


def _step_errors(got, want, msg_norm):
    """(forward ok, forward max abs error, backward ok, backward max error
    of the leaves scaled by their max abs)."""
    ok_f, err_f = True, 0.0
    for a, b in zip(got[0], want[0]):
        ok, mabs, _ = _within(a, b)
        ok_f, err_f = ok_f and ok, max(err_f, mabs)
    ok_b, err_b = True, 0.0
    da0_scale = float(want[1][1].abs().max())
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        if i == 2 and msg_norm == "bn1d":        # message_bias
            d = float((a - b).abs().max())
            ok_b = ok_b and d <= ATOL * da0_scale
            err_b = max(err_b, d / max(da0_scale, 1e-30))
            continue
        scale = float(b.abs().max()) or 1.0
        ok, mabs, _ = _within(a / scale, b / scale)
        ok_b, err_b = ok_b and ok, max(err_b, mabs)
    return ok_f, err_f, ok_b, err_b


def _serving_net(gen, cfg, device):
    """network_init(cfg) from `gen`, every norm's affine and running
    statistics and every message bias random."""
    import torch
    from mpnn_tpu_torch.models.network import network_init
    net = network_init(cfg, gen, "cpu")
    with torch.no_grad():
        for mod in net.modules():
            if hasattr(mod, "running_var"):
                f = mod.weight.shape[0]
                mod.weight.copy_(1 + 0.2 * torch.randn(f, generator=gen))
                mod.bias.copy_(0.2 * torch.randn(f, generator=gen))
                mod.running_mean.copy_(0.3 * torch.randn(f, generator=gen))
                mod.running_var.copy_(0.3 + torch.rand(f, generator=gen))
        for mp in net.mpnn.message:
            mb = mp.message_bias
            mb.copy_(0.2 * torch.randn(mb.shape[0], generator=gen))
    return net.to(device)


def phase_serve(device):
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models.network import network_apply_packed
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.trainer import batch_to_device
    os.makedirs(OUT_DIR, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    probe, ge = G.encode_molgraphs(G.generate_molgraphs(SMILES, [0.0] * 10))
    afm, bfm, nafm = ge.atom_width(), ge.bond_width(), probe[0].nafm.shape[1]
    from mpnn_tpu_torch.models import zoo
    net = _serving_net(gen, zoo.lipo(afm, bfm, nafm), "cpu")
    ckpt = os.path.join(OUT_DIR, "ckpt.npz")
    save_checkpoint(ckpt, net, meta={"seed": 0, "model": "lipo"})
    total_launches, runs, lines = 0, {}, []
    for bs, rows in ((16, 64), (1024, 3072)):
        csv = os.path.join(OUT_DIR, f"new_{bs}.csv")
        smiles = (SMILES * (rows // len(SMILES) + 1))[:rows]
        with open(csv, "w") as fh:
            fh.write("smiles,exp\n")
            for i, s in enumerate(smiles):
                fh.write(f"{s},{0.01 * (i % 97) - 0.3}\n")
        buf = io.StringIO()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", "lipo", "--data", csv,
                      "--ckpt", ckpt, "--batch-size", str(bs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts["fused_eval"]
        recs = [json.loads(x) for x in buf.getvalue().splitlines() if x]
        preds = torch.tensor([r["pred"] for r in recs], dtype=torch.float64)
        n_req = -(-rows // bs)
        if len(recs) != rows or [r["index"] for r in recs] != list(
                range(rows)):
            raise RuntimeError(f"predict at batch {bs}: {len(recs)} "
                               f"records for {rows} molecules")
        if not torch.isfinite(preds).all():
            raise RuntimeError(f"predict at batch {bs}: non-finite output")
        if launches != n_req:
            raise RuntimeError(f"predict at batch {bs}: {launches} kernel "
                               f"launches for {n_req} requests")
        total_launches += launches
        # the plain path on the same card, same checkpoint and batches
        gs, _ = G.load_number_dataset(csv, "smiles", "exp")
        pnet, _ = load_checkpoint(ckpt, net.cfg, device=device)
        loader = G.GraphLoader(gs, bs, collate="packed")
        with torch.no_grad():
            plain = torch.cat([
                network_apply_packed(pnet, batch_to_device(b, device),
                                     fused=False).reshape(-1).cpu()
                for b in loader]).to(torch.float64)
        ok, mabs, mrel = _within(preds, plain)
        lines.append(f"batch {bs}: {rows} molecules in {n_req} requests, "
                     f"{launches} kernel launches, {wall:.2f} s wall "
                     f"(featurize+load+serve), pred range "
                     f"[{float(preds.min()):.4f}, {float(preds.max()):.4f}],"
                     f" vs plain path max_abs={mabs:.3e} max_rel={mrel:.3e}"
                     f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"batch {bs}: served predictions disagree "
                               f"with the plain path ({mabs:.3e})")
        runs[bs] = (pnet, loader)
    print("serve: " + "; ".join(lines), flush=True)
    return total_launches, runs


def _bound_ms(b, f, od, k, steps):
    """Least time of the eval kernel's work on this batch: the larger of
    its float32 operations over the peak CUDA-core rate and its bytes
    (each input read once, the output written once) over HBM bandwidth.
    Counts real nodes and edges only."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    ops = (nr * f + g * 2 * f * f                 # S_g and A0·S_g
           + er * 2 * f * f                        # per-edge A·h0 and sum
           + nr * 5 * f                            # + base + bias, affine
           + nr * (2 * f * 3 * f + 3 * f)          # input gates
           + steps * nr * (2 * f * 3 * f + 3 * f + 19 * f)   # GRU + norm
           + nr * (2 * 2 * (2 * f) * od + 2 * od + 6 * od))  # readout
    weights = k * f * f + f * f + 6 * f * f + 11 * f + 4 * f * od + 2 * od
    nbytes = 4 * (nr * f + er * 3 + nr + g + weights + g * od)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def _events_ms(fn, reps, warm=5):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def phase_times(device, card, runs):
    import statistics
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models.fused_train import fused_eval_args
    from mpnn_tpu_torch.models.network import mpnn_input
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch)
    out, lines = {}, []
    for bs, (net, loader) in runs.items():
        batches = list(loader)
        b = batches[0]
        step = eval_step_for_batch(net.cfg, "mse", b)

        def request(bb):
            _, o = step(net, batch_to_device(bb, device))
            o.cpu()
            torch.cuda.synchronize()
        reps = 30 if bs <= 16 else 15
        for _ in range(3):
            request(b)
        lat = []
        for i in range(reps):
            t0 = time.perf_counter()
            request(batches[i % len(batches)])
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        loader._collate_chunk(loader._epoch_chunks()[0])
        collate_ms = (time.perf_counter() - t0) * 1e3
        # the kernel alone, at the inputs the main path gives it
        tb = batch_to_device(b, device)
        with torch.no_grad():
            args, kw = fused_eval_args(net.mpnn, mpnn_input(net, tb))
            prep = K.prepare_fused_eval(*args, **kw, check=False)
            k_ms = _events_ms(lambda: K.launch_prepared(prep), 200)
            p_ms = _events_ms(lambda: K.fused_eval_reference(*args, **kw), 20)
            chk_ms = _events_ms(lambda: K.check_batch_layout(
                args[3], args[4], args[5], args[12], args[13], args[14],
                args[15], args[0].shape[0], args[15].graph_node_ptr.shape[0]
                - 1), 10)
        cfg = net.cfg.mpnn
        bound, by, ops, nbytes = _bound_ms(
            b, cfg.node_features, cfg.output_dim, args[0].shape[0],
            cfg.message_steps)
        out[bs] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                       request_ms=statistics.median(lat))
        lines.append(
            f"batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}): request median "
            f"{statistics.median(lat):.3f} ms mean "
            f"{statistics.fmean(lat):.3f} ms (host batch → predictions, "
            f"{reps} reps), host collation {collate_ms:.3f} ms; kernel "
            f"{k_ms * 1e3:.2f} us (events, 200 launches), plain "
            f"{p_ms * 1e3:.1f} us, layout check {chk_ms * 1e3:.1f} us, "
            f"bound {bound * 1e3:.3f} us by {by} ({ops / 1e6:.2f} Mop, "
            f"{nbytes / 1e6:.3f} MB)")
    print(f"times [{card}]: " + "; ".join(lines), flush=True)
    return out


def _device_ops(prof):
    """(device busy us, key_averages rows of the device ops): the kernels
    and copies of a torch.profiler trace, user annotations (such as the
    optimizer's step range "Optimizer.step#Adam.step", which spans its
    kernels and the gaps between them) left out; busy time is the union of
    their intervals."""
    from torch.autograd import DeviceType

    def is_op(e):
        name = getattr(e, "key", None) or e.name
        annotation = getattr(e, "is_user_annotation", None)
        if annotation is None:           # an older profiler: by the name
            annotation = re.fullmatch(r"\S+#\S+", name) is not None
        return e.device_type == DeviceType.CUDA and not annotation
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if is_op(e))
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    return busy, [e for e in prof.key_averages() if is_op(e)]


def phase_profile(device, runs, request_ms):
    """Device-time breakdown of one batch-1024 request: busy time = the
    union of the request's device kernels and copies (_device_ops); the
    idle share compares it with the unprofiled request median. Fails when
    the trace shows no device time for the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch)
    net, loader = runs[1024]
    b = next(iter(loader))
    step = eval_step_for_batch(net.cfg, "mse", b)
    step(net, batch_to_device(b, device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, o = step(net, batch_to_device(b, device))
        o.cpu()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile_1024.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=30))

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy, ops = _device_ops(prof)
    kern = sum(dev(e) for e in ops if "fused_eval_kernel" in e.key)
    if kern <= 0:
        raise RuntimeError("profile: the trace shows no device time for "
                           "fused_eval_kernel")
    top = sorted(ops, key=dev, reverse=True)[:5]
    print(f"profile: batch-1024 request: device busy {busy:.1f} us in "
          f"{sum(e.count for e in ops)} device ops (kernels and copies); "
          f"fused_eval_kernel {kern:.1f} us; device idle share "
          f"{1 - busy / (request_ms * 1e3):.3f} of the {request_ms:.3f} ms "
          f"request median; top: "
          + ", ".join(f"{e.key[:48]} {dev(e):.1f} us x{e.count}"
                      for e in top), flush=True)


TRAIN_ROWS, TRAIN_BATCH, TRAIN_EPOCHS = 640, 16, 2


def _train_csv(rows):
    """bench.py's molecules repeated to `rows`, with smooth labels."""
    csv = os.path.join(OUT_DIR, f"lipo_{rows}.csv")
    smiles = (SMILES * (rows // len(SMILES) + 1))[:rows]
    with open(csv, "w") as fh:
        fh.write("smiles,exp\n")
        for i, s in enumerate(smiles):
            fh.write(f"{s},{0.8 * math.sin(0.7 * i) + 0.1 * (i % 5)}\n")
    return csv


def phase_train(device):
    """The `train` verb as a user runs it, launch counts read around it;
    the first 3 steps against the plain path on the card from the same
    weights and batches; then `predict` from the checkpoint it wrote.
    Returns the training kernels' launch counts."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    os.makedirs(OUT_DIR, exist_ok=True)
    csv = _train_csv(TRAIN_ROWS)
    log = os.path.join(OUT_DIR, "train_log.jsonl")
    ckdir = os.path.join(OUT_DIR, "train_ckpt")
    if os.path.exists(log):
        os.remove(log)
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--experiment", "lipo", "--data", csv,
                  "--epochs", str(TRAIN_EPOCHS), "--batch-size",
                  str(TRAIN_BATCH), "--ckpt-dir", ckdir, "--log", log])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(log) as fh:
        recs = [json.loads(x) for x in fh if x.strip()]
    steps = [r["loss"] for r in recs if "step" in r]
    epochs = [r for r in recs if "train_loss" in r]
    # the split and batches the verb used
    gs, _ = G.load_number_dataset(csv, "smiles", "exp")
    train_gs, test_gs = train_test_split(gs, 0.1, 317)
    train_gs, val_gs = train_test_split(train_gs, 0.1, 317)
    per_epoch = -(-len(train_gs) // TRAIN_BATCH)
    n_val = -(-len(val_gs) // TRAIN_BATCH)
    n_test = -(-len(test_gs) // TRAIN_BATCH)
    if len(steps) != TRAIN_EPOCHS * per_epoch or len(epochs) != TRAIN_EPOCHS:
        raise RuntimeError(f"train: {len(steps)} steps logged, expected "
                           f"{TRAIN_EPOCHS * per_epoch}")
    want = {"fused_step_fwd": len(steps), "fused_step_bwd": len(steps),
            "fused_eval": TRAIN_EPOCHS * n_val + n_test}
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"train: launches {counts}, the design's count "
                           f"is {want} (one forward and one backward "
                           f"launch per step, one eval launch per "
                           f"validation and test batch)")
    if not (all(math.isfinite(x) for x in steps)
            and math.isfinite(result["test"]["loss"])
            and all(math.isfinite(r["val_loss"]) for r in epochs)):
        raise RuntimeError("train: non-finite loss")
    # the plain path on the card: the trainer's initial weights (seed 317)
    # and its first three shuffled batches
    afm = int(gs[0].afm.shape[-1])
    cfg = zoo.lipo(afm, int(gs[0].bfm.shape[-1]), int(gs[0].nafm.shape[-1]))
    net = network_init(cfg, torch.Generator().manual_seed(317), device)
    opt = adam(net.parameters(), 1e-2, weight_decay=1e-4)
    loader = G.GraphLoader(train_gs, TRAIN_BATCH, shuffle=True, seed=317)
    plain = []
    for b in loader:
        if len(plain) == 3:
            break
        plain.append(float(train_step(net, opt, batch_to_device(b, device),
                                      fused=False)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if rel > 1e-3:
        raise RuntimeError(f"train: first steps {steps[:3]} vs plain path "
                           f"{plain} (rel {rel:.2e} > 1e-3)")
    # serve the checkpoint the run wrote
    ckpt = os.path.join(ckdir, f"ckpt_{TRAIN_EPOCHS - 1}.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["predict", "--experiment", "lipo", "--data", csv,
                  "--ckpt", ckpt, "--batch-size", "64"])
    preds = [json.loads(x)["pred"] for x in buf.getvalue().splitlines() if x]
    if len(preds) != TRAIN_ROWS or not all(math.isfinite(p) for p in preds):
        raise RuntimeError("train: predict from the written checkpoint "
                           "failed")
    print(f"train: `train` verb, {TRAIN_ROWS} molecules (train "
          f"{len(train_gs)}, val {len(val_gs)}, test {len(test_gs)}), batch "
          f"{TRAIN_BATCH}, {TRAIN_EPOCHS} epochs, {len(steps)} steps in "
          f"{wall:.2f} s wall (featurize + train + validate + checkpoint); "
          f"launches fused_step_fwd {counts['fused_step_fwd']}, "
          f"fused_step_bwd {counts['fused_step_bwd']}, fused_eval "
          f"{counts['fused_eval']} (design: 1 + 1 per step, 1 per eval "
          f"batch); step losses first {steps[0]:.5f} last {steps[-1]:.5f};"
          f" epoch val_loss {[round(r['val_loss'], 5) for r in epochs]}, "
          f"lr {[r['lr'] for r in epochs]}; test loss "
          f"{result['test']['loss']:.5f}; first 3 steps vs plain path "
          f"max rel {rel:.2e} (kernel {[round(x, 6) for x in steps[:3]]}, "
          f"plain {[round(x, 6) for x in plain]}); predict from "
          f"ckpt_{TRAIN_EPOCHS - 1}.npz: {len(preds)} finite predictions",
          flush=True)
    return counts


def _step_bounds(b, f, od, k, steps):
    """Least times of the training kernels' work on this batch, each the
    larger of its float32 operations over the peak CUDA-core rate and its
    bytes (each input read once, each output written once, the residual
    stash written by the forward and read by the backward) over HBM
    bandwidth. Real nodes and edges only.

    The function's own work, not the kernels': the messages, and so the
    input gates gi = W_ih·m + b_ih, are the same in every step, so the
    forward takes them once and each step one W_hh GEMV. The backward
    takes per step one W_hh GEMV (the gates, recomputed from the stash),
    W_hhᵀ·dg and the dW_hh outer product, and sums dgi over the steps;
    W_ih's two products run once, on Σ_t dgi_t. The readout's VJP
    recomputes its two GEMVs and takes their transposes and outer
    products."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    weights = k * f * f + f * f + 6 * f * f + 11 * f + 4 * f * od + 2 * od
    gemv = 2 * f * 3 * f                           # one f → 3f gate GEMV
    gate = 3 * f + 12 * f                          # + b_hh, the gate math
    norm = 8 * f                                   # stats + normalize
    ro_gemv = 2 * 2 * (2 * f) * od                 # W_i·x and W_j·x
    fwd_ops = (er * 2 * f * f + g * 2 * f * f + nr * 3 * f  # messages
               + nr * norm + nr * (gemv + 3 * f)            # ma BN, gi once
               + steps * nr * (gemv + gate + norm)
               + nr * (ro_gemv + 8 * od) + g * 3 * od)      # readout, loss
    stash = (steps + 1) * nr * f + 2 * (steps + 1) * f
    fwd_bytes = 4 * (nr * f + er * 3 + nr + g * 2 + weights + 1 + g * od
                     + stash)
    bwd_ops = (nr * (3 * ro_gemv + 16 * od)                  # readout VJP
               + steps * nr * (3 * gemv + gate + 20 * f + 2 * norm)
               + nr * 2 * gemv                               # W_ih, Σ dgi
               + nr * 2 * norm                               # message BN
               + er * 4 * f * f + g * 4 * f * f + nr * 4 * f)  # message VJP
    bwd_bytes = 4 * (nr * f + er * 3 + 2 * nr + g * (2 + 2 * od) + 1
                     + weights + stash + nr * f + weights)
    out = {}
    for name, ops, nbytes in (("fused_step_fwd", fwd_ops, fwd_bytes),
                              ("fused_step_bwd", bwd_ops, bwd_bytes)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def _train_net(b, gen, device):
    import torch
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    cfg = zoo.lipo(b["node_feats"].shape[1], b["edge_feats"].shape[1],
                   b["node_nafm"].shape[1])
    net = network_init(cfg, gen, device)
    return net, adam(net.parameters(), 1e-2, weight_decay=1e-4)


def _kernel_trace_us(*prepared):
    """Device time of one launch of each prepared training kernel, from a
    torch.profiler trace (the events' time over back-to-back launches also
    holds any host launch gap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpnn_tpu_torch.kernels import fused_step as K
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for p in prepared:
            K.launch_prepared(p)
        torch.cuda.synchronize()
    _, ops = _device_ops(prof)
    return {p.name: sum(getattr(e, "self_device_time_total", 0.0)
                        for e in ops if f"{p.name}_kernel" in e.key)
            for p in prepared}


def phase_train_times(device, card):
    """Train-step latency (host clock ending in a device sync, the loss
    read back) at batch 16 and 1024, and each training kernel's time
    (CUDA events over repeated launches on the main path's inputs) beside
    its bound and its plain version's time (autograd through
    fused_step_reference for the backward)."""
    import statistics
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models.fused_train import fused_step_args
    from mpnn_tpu_torch.models.network import mpnn_input
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    out, lines = {}, []
    gen = torch.Generator().manual_seed(2)
    for bs in (16, 1024):
        b = _batch((SMILES * (bs // len(SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randn(bs, generator=gen).numpy()
        tb = batch_to_device(b, device)
        net, opt = _train_net(b, gen, device)
        reps = 30 if bs <= 16 else 15
        for _ in range(3):
            float(train_step(net, opt, tb))
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(train_step(net, opt, tb))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        # the kernels alone, on the inputs the main path gives them
        mb, _ = mpnn_input(net, tb, training=True)
        args, kw = fused_step_args(net.mpnn, mb, tb["labels"])
        args = [a.detach() if isinstance(a, torch.Tensor) else a
                for a in args]
        (amat, a0, mbias, h0, mask, ng, gru, ma, bnp, ro, labels, gmask,
         vid, src, dst, plan) = args
        det = lambda d: {k: (det(v) if isinstance(v, dict) else v.detach())
                         for k, v in d.items()}
        gru, ma, bnp, ro = det(gru), det(ma), det(bnp), det(ro)
        weights = K._flat_weights(amat, a0, mbias, gru, ma, bnp, ro)
        meta = K.StepMeta(kw["steps"], 1, 1)
        pf = K.prepare_fused_step_fwd(weights, h0, mask, ng, labels, gmask,
                                      vid, src, dst, plan, meta)
        f_ms = _events_ms(lambda: K.launch_prepared(pf), 100)
        _, o, st, htil = K.launch_prepared(pf)
        gout = torch.randn(o.shape, generator=gen).to(device)
        gl = torch.ones(1, device=device)
        pb = K.prepare_fused_step_bwd(weights, h0, labels, gmask, o, gout,
                                      gl, htil, st, ng, vid, src, dst, plan,
                                      meta)
        b_ms = _events_ms(lambda: K.launch_prepared(pb), 100)
        trace_us = _kernel_trace_us(pf, pb)
        ref_args = (amat, a0, mbias, h0, mask, ng, gru, ma, bnp, ro, labels,
                    gmask, vid, src, dst, plan)
        with torch.no_grad():
            pf_ms = _events_ms(lambda: K.fused_step_reference(*ref_args,
                                                              **kw), 10)
        leaves = [x.requires_grad_() for _, x in weights] + [
            h0.requires_grad_()]
        loss, o_ref, _, _ = K.fused_step_reference(*ref_args, **kw)
        obj = loss + (o_ref * gout).sum()
        pb_ms = _events_ms(lambda: torch.autograd.grad(
            obj, leaves, retain_graph=True, allow_unused=True), 10)
        cfg = net.cfg.mpnn
        bounds = _step_bounds(b, cfg.node_features, cfg.output_dim,
                              amat.shape[0], cfg.message_steps)
        out[bs] = {"step_ms": statistics.median(lat),
                   "fused_step_fwd": dict(ms=f_ms, plain_ms=pf_ms),
                   "fused_step_bwd": dict(ms=b_ms, plain_ms=pb_ms)}
        for name in ("fused_step_fwd", "fused_step_bwd"):
            out[bs][name]["trace_us"] = trace_us[name]
        for name in ("fused_step_fwd", "fused_step_bwd"):
            bound, by, ops, nbytes = bounds[name]
            out[bs][name].update(bound_ms=bound, bound_by=by)
        lines.append(
            f"batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}, vocab {amat.shape[0]}): train step "
            f"median {statistics.median(lat):.3f} ms mean "
            f"{statistics.fmean(lat):.3f} ms ({reps} reps, loss read back); "
            + ", ".join(
                f"{name} {out[bs][name]['ms'] * 1e3:.2f} us (events, 100 "
                f"launches; {out[bs][name]['trace_us']:.2f} us device time "
                f"of one launch in a trace), plain {out[bs][name]['plain_ms'] * 1e3:.1f} us, "
                f"bound {bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.2f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)"
                for name in ("fused_step_fwd", "fused_step_bwd")))
    print(f"train-times [{card}]: " + "; ".join(lines), flush=True)
    return out


def phase_train_profile(device, step_ms):
    """Device-time breakdown of one batch-1024 train step (forward,
    backward, Adam, running statistics); fails when the trace shows no
    device time for either training kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    gen = torch.Generator().manual_seed(3)
    b = _batch((SMILES * 103)[:1024], 1024)
    b["labels"] = torch.randn(1024, generator=gen).numpy()
    net, opt = _train_net(b, gen, device)
    for _ in range(2):
        float(train_step(net, opt, batch_to_device(b, device)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(train_step(net, opt, batch_to_device(b, device)))
        torch.cuda.synchronize()
    ka = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile_train_1024.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy, ops = _device_ops(prof)
    kern = {k: sum(dev(e) for e in ops if f"{k}_kernel" in e.key)
            for k in ("fused_step_fwd", "fused_step_bwd")}
    if min(kern.values()) <= 0:
        raise RuntimeError(f"train-profile: no device time for {kern}")
    top = sorted(ops, key=dev, reverse=True)[:6]
    print(f"train-profile: batch-1024 train step (H2D + forward + backward"
          f" + Adam + EMAs + loss read-back): device busy {busy:.1f} us in "
          f"{sum(e.count for e in ops)} device ops; fused_step_fwd_kernel "
          f"{kern['fused_step_fwd']:.1f} us, fused_step_bwd_kernel "
          f"{kern['fused_step_bwd']:.1f} us; device idle share "
          f"{1 - busy / (step_ms * 1e3):.3f} of the {step_ms:.3f} ms step "
          f"median; top: "
          + ", ".join(f"{e.key[:48]} {dev(e):.1f} us x{e.count}"
                      for e in top), flush=True)


# ---------------------------------------------------------------------------
# the per-step family (graph_norm, encoded): phases 10-13
# ---------------------------------------------------------------------------

PS_NORMS = [(m, s) for m in ("bn1d", "none")
            for s in ("bn1d", "stateless", "none")]
PS_EXPERIMENTS = (("graph_norm_classification", "graph_norm"),
                  ("encoded_classification", "encoded"))
PS_CLASSES = 4
PS_KERNELS = ("fused_psteps_eval", "fused_psteps_fwd", "fused_psteps_bwd")


def _ps_case(tb, f, od, gen, device, steps=3, from_feats=False):
    """The per-step ops' arguments on a device batch `tb`, as a dict: h0
    the batch's node features (graph_norm's f = afm) or random (N, f)
    rows, masked; random per-step weights (vocab id 0 the zero row) and
    running statistics; random labels and one padded graph slot. The
    differentiable leaves require grad; returns (case, leaves)."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)
    mask = tb["node_mask"]
    h0 = tb["node_feats"] if from_feats else r(mask.shape[0], f)
    amat = r(steps, int(tb["edge_vfirst"].shape[0]), f, f, s=0.2)
    amat[:, 0] = 0.0
    g = int(tb["graph_mask"].shape[0])
    gmask = torch.ones(g, device=device)
    gmask[-1] = 0.0
    c = dict(amat=amat, a0=r(steps, f, f, s=0.1), mbias=r(steps, f, s=0.1),
             h0=(h0 * mask).contiguous(), mask=mask,
             node_graph=tb["node_graph"],
             gru={"w_ih": r(f, 3 * f, s=0.3), "w_hh": r(f, 3 * f, s=0.3),
                  "b_ih": r(3 * f, s=0.1), "b_hh": r(3 * f, s=0.1)},
             ro={"i": {"w": r(2 * f, od, s=0.3), "b": r(od, s=0.1)},
                 "j": {"w": r(2 * f, od, s=0.3), "b": r(od, s=0.1)}},
             ma_bns=[{"weight": 1 + r(f, s=0.2), "bias": r(f, s=0.2)}
                     for _ in range(steps)],
             bns=[{"weight": 1 + r(f, s=0.2), "bias": r(f, s=0.2)}
                  for _ in range(steps)],
             ma_states=[{"running_mean": r(f, s=0.3), "running_var": (
                 0.3 + torch.rand(f, generator=gen)).to(device)}
                 for _ in range(steps)],
             bn_states=[{"running_mean": r(f, s=0.3), "running_var": (
                 0.3 + torch.rand(f, generator=gen)).to(device)}
                 for _ in range(steps)],
             labels=r(g), gmask=gmask, vid=tb["edge_vid"],
             src=tb["edge_src"], dst=tb["edge_dst"],
             plan=plan_from_batch(tb))
    leaves = [c["amat"], c["a0"], c["mbias"], c["h0"], *c["gru"].values(),
              *[b[k] for b in c["ma_bns"] for k in ("weight", "bias")],
              *[b[k] for b in c["bns"] for k in ("weight", "bias")],
              c["ro"]["i"]["w"], c["ro"]["i"]["b"], c["ro"]["j"]["w"],
              c["ro"]["j"]["b"]]
    for x in leaves:
        x.requires_grad_()
    return c, leaves


def _ps_eval_call(fn, c, **kw):
    return fn(c["amat"], c["a0"], c["mbias"], c["h0"], c["mask"],
              c["node_graph"], c["gru"], c["ma_bns"], c["ma_states"],
              c["bns"], c["bn_states"], c["ro"], c["vid"], c["src"],
              c["dst"], c["plan"], **kw)


def _ps_step_args(c):
    """fused_psteps' positional arguments from a _ps_case dict."""
    return (c["amat"], c["a0"], c["mbias"], c["h0"], c["mask"],
            c["node_graph"], c["gru"], c["ma_bns"], c["bns"], c["ro"],
            c["labels"], c["gmask"], c["vid"], c["src"], c["dst"],
            c["plan"])


def phase_ps_kernel_check(device):
    """The per-step kernels against their plain versions on the card."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(11)
    b1024 = batch_to_device(_batch((SMILES * 103)[:1024], 1024), device)
    ragged_smiles = SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
    ragged = batch_to_device(_batch(ragged_smiles, len(ragged_smiles)),
                             device)
    big = batch_to_device(_batch((SMILES * 256)[:2560], 2560), device)
    # graph_norm's widths come from the batch: f = afm, od = 4·afm
    cases = ([("batch1024", b1024, 8, mn, sn) for mn, sn in PS_NORMS]
             + [("batch1024 graph_norm", b1024, None, "none", "stateless"),
                ("ragged", ragged, 8, "bn1d", "bn1d"),
                ("ragged graph_norm", ragged, None, "none", "stateless"),
                ("batch2560", big, 8, "bn1d", "bn1d")])
    worst = dict.fromkeys(PS_KERNELS, 0.0)
    results, failed = [], []
    for what, tb, f, mn, sn in cases:
        feats = f is None
        f = int(tb["node_feats"].shape[1]) if feats else f
        od = 4 * f if feats else 16
        c, leaves = _ps_case(tb, f, od, gen, device, from_feats=feats)
        kw = dict(steps=3, msg_norm=mn, state_norm=sn)
        with torch.no_grad():
            got = _ps_eval_call(P.fused_psteps_eval, c, **kw)
            torch.cuda.synchronize()
            want = _ps_eval_call(P.fused_psteps_eval_reference, c, **kw)
        ok_e, err_e, _ = _within(got, want)
        ok_e = ok_e and bool(torch.isfinite(got).all())
        cw = torch.randn(want.shape, generator=gen).to(device)
        got = _step_and_grads(P.fused_psteps, _ps_step_args(c), leaves,
                              cw, kw)
        torch.cuda.synchronize()
        want = _step_and_grads(P.fused_psteps_reference, _ps_step_args(c),
                               leaves, cw, kw)
        ok_f, err_f, ok_b, err_b = _step_errors(got, want, mn)
        for name, err in zip(PS_KERNELS, (err_e, err_f, err_b)):
            worst[name] = max(worst[name], err)
        ok = ok_e and ok_f and ok_b
        results.append(
            f"{what} {mn}/{sn} f={f} od={od} (nodes "
            f"{int(tb['node_mask'].sum())}/{tb['node_mask'].shape[0]} "
            f"slots, G={tb['graph_mask'].shape[0]}): eval max_abs="
            f"{err_e:.3e} fwd max_abs={err_f:.3e} bwd max_scaled="
            f"{err_b:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{what} {mn}/{sn}")
    print(f"ps-kernel-check: fused_psteps_eval vs fused_psteps_eval_"
          f"reference, fused_psteps_fwd vs fused_psteps_reference, "
          f"fused_psteps_bwd vs autograd through it (T 3, cotangents "
          f"1.3·loss + Σ out·c; rtol {RTOL} atol {ATOL}, gradient leaves "
          f"divided by their max abs; message biases under the message "
          f"bn1d within {ATOL}·max|dA0|): " + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"per-step kernels disagree with their plain "
                           f"versions: {failed}")
    return worst


def _ps_csv(name, rows):
    """bench.py's molecules repeated to `rows`, with seeded classes."""
    import numpy as np
    csv = os.path.join(OUT_DIR, f"{name}_{rows}.csv")
    smiles = (SMILES * (rows // len(SMILES) + 1))[:rows]
    labels = np.random.RandomState(rows).randint(0, PS_CLASSES, rows)
    labels[:PS_CLASSES] = np.arange(PS_CLASSES)     # every class present
    with open(csv, "w") as fh:
        fh.write("smiles,target\n")
        for s, y in zip(smiles, labels):
            fh.write(f"{s},{y}\n")
    return csv


def phase_ps_serve(device):
    """`predict` of both per-step experiments as a user runs it, launch
    counts read around it, logits against the plain path on the card.
    Returns the eval kernel's launches."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_apply_packed
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.trainer import batch_to_device
    os.makedirs(OUT_DIR, exist_ok=True)
    probe, ge = G.encode_molgraphs(G.generate_molgraphs(SMILES, [0] * 10))
    afm, bfm, nafm = ge.atom_width(), ge.bond_width(), probe[0].nafm.shape[1]
    total, lines = 0, []
    for exp, model in PS_EXPERIMENTS:
        gen = torch.Generator().manual_seed(21)
        net = _serving_net(gen, zoo.build(
            model, afm=afm, bfm=bfm, nafm=nafm, n_out=PS_CLASSES), "cpu")
        ckpt = os.path.join(OUT_DIR, f"ckpt_{model}.npz")
        save_checkpoint(ckpt, net, meta={"seed": 21, "model": model})
        for bs, rows in ((16, 64), (1024, 3072)):
            csv = _ps_csv(f"new_{model}", rows)
            buf = io.StringIO()
            P.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["predict", "--experiment", exp, "--data", csv,
                          "--ckpt", ckpt, "--batch-size", str(bs)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = P.launch_counts["fused_psteps_eval"]
            recs = [json.loads(x) for x in buf.getvalue().splitlines() if x]
            n_req = -(-rows // bs)
            if len(recs) != rows or [r["index"] for r in recs] != list(
                    range(rows)):
                raise RuntimeError(f"{exp} predict at batch {bs}: "
                                   f"{len(recs)} records for {rows}")
            logits = torch.tensor([r["logits"] for r in recs],
                                  dtype=torch.float64)
            if not torch.isfinite(logits).all() or any(
                    r["pred"] != int(torch.argmax(lg))
                    for r, lg in zip(recs, logits)):
                raise RuntimeError(f"{exp} predict at batch {bs}: "
                                   "non-finite logits or a wrong argmax")
            if launches != n_req:
                raise RuntimeError(f"{exp} predict at batch {bs}: "
                                   f"{launches} kernel launches for "
                                   f"{n_req} requests")
            total += launches
            gs, _, _, _ = G.load_classification_dataset(csv, "smiles",
                                                        "target")
            pnet, _ = load_checkpoint(ckpt, net.cfg, device=device)
            with torch.no_grad():
                plain = torch.cat([
                    network_apply_packed(pnet, batch_to_device(b, device),
                                         fused=False).cpu()
                    for b in G.GraphLoader(gs, bs)]).to(torch.float64)
            ok, mabs, mrel = _within(logits, plain)
            lines.append(f"{exp} batch {bs}: {rows} molecules in {n_req} "
                         f"requests, {launches} kernel launches, "
                         f"{wall:.2f} s wall (featurize+load+serve), logits "
                         f"vs plain path max_abs={mabs:.3e} "
                         f"max_rel={mrel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{exp} batch {bs}: served logits "
                                   f"disagree with the plain path "
                                   f"({mabs:.3e})")
    print("ps-serve: " + "; ".join(lines), flush=True)
    return total


def phase_ps_train(device):
    """The `train` verb of both per-step experiments as a user runs it,
    launch counts read around it; the first 3 steps against the plain
    path on the card; then `predict` from a checkpoint. Returns the
    training kernels' launches."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train import cli, experiments
    from mpnn_tpu_torch.train.checkpoint import save_checkpoint
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    totals, lines = dict.fromkeys(PS_KERNELS, 0), []
    for exp_name, model in PS_EXPERIMENTS:
        exp = experiments.get(exp_name)
        csv = _ps_csv(f"train_{model}", TRAIN_ROWS)
        log = os.path.join(OUT_DIR, f"train_{model}.jsonl")
        ckdir = os.path.join(OUT_DIR, f"train_ckpt_{model}")
        if os.path.exists(log):
            os.remove(log)
        buf = io.StringIO()
        P.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["train", "--experiment", exp_name, "--data", csv,
                      "--epochs", str(TRAIN_EPOCHS), "--ckpt-dir", ckdir,
                      "--log", log])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(P.launch_counts)
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        with open(log) as fh:
            recs = [json.loads(x) for x in fh if x.strip()]
        steps = [r["loss"] for r in recs if "step" in r]
        epochs = [r for r in recs if "train_loss" in r]
        gs, _, _, _ = G.load_classification_dataset(csv, "smiles", "target")
        bs = exp.train.batch_size
        train_gs, test_gs = train_test_split(gs, 0.1, 317)
        train_gs, val_gs = train_test_split(train_gs, 0.1, 317)
        per_epoch = -(-len(train_gs) // bs)
        want = {"fused_psteps_fwd": TRAIN_EPOCHS * per_epoch,
                "fused_psteps_bwd": TRAIN_EPOCHS * per_epoch,
                "fused_psteps_eval": TRAIN_EPOCHS * -(-len(val_gs) // bs)
                + -(-len(test_gs) // bs)}
        if len(steps) != want["fused_psteps_fwd"] or counts != want:
            raise RuntimeError(f"{exp_name} train: {len(steps)} steps, "
                               f"launches {counts}; the design's count is "
                               f"{want}")
        if not (all(math.isfinite(x) for x in steps)
                and math.isfinite(result["test"]["loss"])
                and all(math.isfinite(r["val_loss"]) for r in epochs)):
            raise RuntimeError(f"{exp_name} train: non-finite loss")
        for k in PS_KERNELS:
            totals[k] += counts[k]
        # the plain path on the card: the trainer's initial weights (seed
        # 317) and its first three shuffled batches
        cfg = zoo.build(model, afm=int(gs[0].afm.shape[-1]),
                        bfm=int(gs[0].bfm.shape[-1]),
                        nafm=int(gs[0].nafm.shape[-1]), n_out=PS_CLASSES)
        net = network_init(cfg, torch.Generator().manual_seed(317), device)
        opt = adam(net.parameters(), exp.train.learning_rate,
                   weight_decay=exp.train.weight_decay)
        plain = []
        for b in G.GraphLoader(train_gs, bs, shuffle=True, seed=317):
            if len(plain) == 3:
                break
            plain.append(float(train_step(net, opt, batch_to_device(
                b, device), fused=False, loss_kind="ce")))
        rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
        if rel > 1e-3:
            raise RuntimeError(f"{exp_name} train: first steps {steps[:3]} "
                               f"vs plain path {plain} (rel {rel:.2e})")
        # the F1 gate keeps the verb's checkpoints back at random weights:
        # serve the last one it wrote, or one saved from the seed
        written = sorted((f for f in os.listdir(ckdir) if f.endswith(
            ".npz")), key=lambda f: int(f[5:-4])) \
            if os.path.isdir(ckdir) else []
        if written:
            ckpt = os.path.join(ckdir, written[-1])
        else:
            ckpt = os.path.join(OUT_DIR, f"seed_{model}.npz")
            save_checkpoint(ckpt, network_init(
                cfg, torch.Generator().manual_seed(317), "cpu"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", exp_name, "--data", csv,
                      "--ckpt", ckpt])
        preds = [json.loads(x) for x in buf.getvalue().splitlines() if x]
        if len(preds) != TRAIN_ROWS or not all(
                math.isfinite(v) for r in preds for v in r["logits"]):
            raise RuntimeError(f"{exp_name}: predict from {ckpt} failed")
        lines.append(
            f"{exp_name}: {TRAIN_ROWS} molecules (train {len(train_gs)}, "
            f"val {len(val_gs)}, test {len(test_gs)}), batch {bs}, "
            f"{TRAIN_EPOCHS} epochs, {len(steps)} steps in {wall:.2f} s "
            f"wall; launches fwd {counts['fused_psteps_fwd']}, bwd "
            f"{counts['fused_psteps_bwd']}, eval "
            f"{counts['fused_psteps_eval']} (design: 1 + 1 per step, 1 per "
            f"eval batch); step losses first {steps[0]:.5f} last "
            f"{steps[-1]:.5f}; val f1 {[round(r['val_f1'], 4) for r in epochs]}"
            f" (gate {exp.train.ckpt_f1_gate}, {len(written)} checkpoints "
            f"written); test f1 {result['test']['f1']:.4f}; first 3 steps "
            f"vs plain path max rel {rel:.2e}; predict from "
            f"{os.path.basename(ckpt)}: {len(preds)} finite records")
    print("ps-train: " + "; ".join(lines), flush=True)
    return totals


def _ps_bounds(b, f, od, k, steps, msg_norm, state_norm):
    """Least times of the per-step kernels' work on this batch, each the
    larger of its float32 operations over the peak CUDA-core rate and its
    bytes (each input read once, each output written once, the residual
    stash written by the forward and read by the backward) over HBM
    bandwidth. Real nodes and edges only; T message tables, so the edge
    work and the messages' input gates are per step (_step_bounds counts
    them once for the shared family). The norms as each kernel computes
    them in these modes: in training a norm on batch statistics, at
    serving time a folded eval bn1d is a per-feature affine and only the
    stateless norm takes statistics; 'none' costs nothing."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    T = steps
    weights = (T * k * f * f + T * f * f + 6 * f * f + 6 * f + 5 * T * f
               + 4 * f * od + 2 * od)
    gemv = 2 * f * 3 * f                           # one f → 3f gate GEMV
    gate = 3 * f + 12 * f                          # + b_hh, the gate math
    norm = 8 * f                                   # stats + normalize
    affine = 2 * f                                 # a folded eval bn1d
    # per node and step, the message norm's and the state norm's work
    train_norms = norm * ((msg_norm != "none") + (state_norm != "none"))
    eval_norms = ({"bn1d": affine, "none": 0}[msg_norm]
                  + {"bn1d": affine, "stateless": norm,
                     "none": 0}[state_norm])
    ro_gemv = 2 * 2 * (2 * f) * od                 # W_i·x and W_j·x
    msgs = er * T * 2 * f * f + g * T * 2 * f * f + nr * f + nr * T * 2 * f
    core = (msgs + T * nr * (2 * gemv + 3 * f + gate)
            + nr * (ro_gemv + 8 * od))
    stash = 2 * T * nr * f + 4 * T * f
    batch_bytes = nr * f + er * 3 + nr
    out = {"fused_psteps_eval": (core + T * nr * eval_norms,
                                 4 * (batch_bytes + g + weights + g * od)),
           "fused_psteps_fwd": (core + T * nr * train_norms + g * 3 * od,
                                4 * (batch_bytes + 2 * g + weights + 1
                                     + g * od + stash))}
    bwd = (nr * (3 * ro_gemv + 16 * od)
           + T * nr * (6 * gemv + gate + 20 * f + 2 * train_norms)
           + er * T * 4 * f * f + g * T * 4 * f * f + nr * T * 4 * f)
    out["fused_psteps_bwd"] = (bwd, 4 * (batch_bytes + nr + g * (2 + 2 * od)
                                         + 1 + weights + stash + nr * f
                                         + weights))
    res = {}
    for name, (ops, nbytes) in out.items():
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        res[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return res


def phase_ps_times(device, card):
    """The encoded model at batch 128 and 1024: request latency and
    train-step latency (host clock ending in a device sync), each
    per-step kernel's time (CUDA events over repeated launches on the
    main path's inputs) beside its bound and its plain version's time,
    and the device busy time of one batch-1024 train step."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.fused_train import (fused_psteps_args,
                                                   fused_psteps_eval_args)
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch,
                                              train_step)
    out, lines = {}, []
    gen = torch.Generator().manual_seed(31)
    for bs in (128, 1024):
        b = _batch((SMILES * (bs // len(SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randint(0, PS_CLASSES, (bs,),
                                    generator=gen).numpy()
        tb = batch_to_device(b, device)
        cfg = zoo.encoded(b["node_feats"].shape[1], b["edge_feats"].shape[1],
                          b["node_nafm"].shape[1], n_out=PS_CLASSES)
        net = network_init(cfg, gen, device)
        opt = adam(net.parameters(), 1e-3, weight_decay=1e-5)
        reps = 20
        for _ in range(3):
            float(train_step(net, opt, tb, loss_kind="ce"))
        step_lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(train_step(net, opt, tb, loss_kind="ce"))
            torch.cuda.synchronize()
            step_lat.append((time.perf_counter() - t0) * 1e3)
        estep = eval_step_for_batch(cfg, "ce", b)

        def request():
            _, o = estep(net, batch_to_device(b, device))
            o.cpu()
            torch.cuda.synchronize()
        for _ in range(3):
            request()
        req_lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            request()
            req_lat.append((time.perf_counter() - t0) * 1e3)
        busy = None
        if bs == 1024:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                float(train_step(net, opt, tb, loss_kind="ce"))
                torch.cuda.synchronize()
            busy, ops = _device_ops(prof)
            with open(os.path.join(OUT_DIR, "profile_ps_train_1024.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=40))
        # the kernels alone, on the inputs the main path gives them
        with torch.no_grad():
            args, kw = fused_psteps_eval_args(net.mpnn, tb)
            pe = P.prepare_fused_psteps_eval(*args, **kw)
            e_ms = _events_ms(lambda: K.launch_prepared(pe), 200)
            pe_ms = _events_ms(lambda: P.fused_psteps_eval_reference(
                *args, **kw), 10)
            (sargs, skw), _ = fused_psteps_args(net.mpnn, tb,
                                                tb["labels"].float())
        det = lambda x: ({k: det(v) for k, v in x.items()}
                         if isinstance(x, dict) else
                         [det(v) for v in x] if isinstance(x, list) else
                         x.detach() if isinstance(x, torch.Tensor) else x)
        sargs = [det(a) for a in sargs]
        (amat, a0, mbias, h0, mask, ng, gru, ma, bnp, ro, labels, gmask,
         vid, src, dst, plan) = sargs
        weights, meta = P.flat_weights(amat, a0, mbias, gru, ma, bnp, ro, h0,
                                       **skw)
        pf = P.prepare_fused_psteps_fwd(weights, h0, mask, ng, labels,
                                        gmask, vid, src, dst, plan, meta)
        f_ms = _events_ms(lambda: K.launch_prepared(pf), 100)
        _, o, st, htil = K.launch_prepared(pf)
        gout = torch.randn(o.shape, generator=gen).to(device)
        gl = torch.ones(1, device=device)
        pb = P.prepare_fused_psteps_bwd(weights, h0, labels, gmask, o, gout,
                                        gl, htil, st, ng, vid, src, dst,
                                        plan, meta)
        b_ms = _events_ms(lambda: K.launch_prepared(pb), 100)
        with torch.no_grad():
            pf_ms = _events_ms(lambda: P.fused_psteps_reference(
                *sargs, **skw), 10)
        leaves = [x.requires_grad_() for _, x in weights] + [
            h0.requires_grad_()]
        ref_args = [amat, a0, mbias, h0, mask, ng, gru,
                    [{"weight": weights[7][1][t], "bias": weights[8][1][t]}
                     for t in range(meta.steps)],
                    [{"weight": weights[9][1][t], "bias": weights[10][1][t]}
                     for t in range(meta.steps)],
                    ro, labels, gmask, vid, src, dst, plan]
        loss, o_ref, _, _ = P.fused_psteps_reference(*ref_args, **skw)
        obj = loss + (o_ref * gout).sum()
        pb_ms = _events_ms(lambda: torch.autograd.grad(
            obj, leaves, retain_graph=True, allow_unused=True), 10)
        bounds = _ps_bounds(b, cfg.mpnn.node_features, cfg.mpnn.output_dim,
                            amat.shape[1], cfg.mpnn.message_steps,
                            cfg.mpnn.msg_norm, cfg.mpnn.state_norm)
        rec = {"step_ms": statistics.median(step_lat),
               "request_ms": statistics.median(req_lat),
               "fused_psteps_eval": dict(ms=e_ms, plain_ms=pe_ms),
               "fused_psteps_fwd": dict(ms=f_ms, plain_ms=pf_ms),
               "fused_psteps_bwd": dict(ms=b_ms, plain_ms=pb_ms)}
        for name in PS_KERNELS:
            rec[name].update(bound_ms=bounds[name][0],
                             bound_by=bounds[name][1])
        out[bs] = rec
        idle = "" if busy is None else (
            f"; one train step's device busy {busy:.1f} us in "
            f"{sum(e.count for e in ops)} device ops, idle share "
            f"{1 - busy / (rec['step_ms'] * 1e3):.3f}")
        lines.append(
            f"encoded batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}, vocab {amat.shape[1]}): request "
            f"median {rec['request_ms']:.3f} ms, train step median "
            f"{rec['step_ms']:.3f} ms ({reps} reps each){idle}; "
            + ", ".join(
                f"{name} {rec[name]['ms'] * 1e3:.2f} us (events), plain "
                f"{rec[name]['plain_ms'] * 1e3:.1f} us, bound "
                f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.2f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in PS_KERNELS))
    print(f"ps-times [{card}]: " + "; ".join(lines), flush=True)
    return out


# ---------------------------------------------------------------------------
# the attention model adv (adv_classification): phases 14-17
# ---------------------------------------------------------------------------

ATT_KERNELS = ("fused_att_fwd", "fused_att_bwd", "set2vec_fwd", "set2vec_bwd")
ATT_EXP = "adv_classification"


def _ragged_att_batch(device):
    """bench.py's molecules with single-atom ones, padded edges on the
    dummy node and one padded graph slot at the end."""
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import attach_fused_plan
    from mpnn_tpu_torch.train.trainer import batch_to_device
    smiles = SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
    gs, _ = G.encode_molgraphs(G.generate_molgraphs(smiles, [0] * 12))
    b = G.collate_packed(gs, num_graphs=len(gs) + 1).as_dict()
    b = attach_fused_plan(G.attach_edge_vocab(b, vocab_cap=16))
    return batch_to_device(b, device)


def _att_case(tb, gen, device, w=14):
    """The two ops' arguments on a device batch: fused_att's with h0 the
    batch's (masked) node features and random weights (A' of vid 0 not
    zero), set2vec's with a random masked x (N, w) and leaves drawn as
    the JAX init draws them; (att args, att leaves, s2v args, s2v
    leaves), every leaf requiring grad."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)

    def u(*shape, b):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * b).to(device)
    mask = tb["node_mask"]
    f = int(tb["node_feats"].shape[1])
    k = int(tb["edge_vfirst"].shape[0])
    h0 = (tb["node_feats"] * mask).contiguous()
    gru = {"w_ih": r(f, 3 * f, s=0.3), "w_hh": r(f, 3 * f, s=0.3),
           "b_ih": r(3 * f, s=0.1), "b_hh": r(3 * f, s=0.1)}
    aw = dict(aprime=r(k, f, f, s=0.3), a0=r(f, f, s=0.3), qv=r(k, f),
              q0=r(f), wh=r(f, f, s=0.5))
    att_leaves = [*aw.values(), h0, *gru.values()]
    att_args = (aw["aprime"], aw["a0"], aw["qv"], aw["q0"], aw["wh"], h0,
                mask, tb["node_graph"], gru, tb["edge_vid"], tb["edge_src"],
                tb["edge_dst"], plan_from_batch(tb))
    b = (2 * w) ** -0.5
    rp = {"lstm": {**{f"w_h{c}": u(2 * w, w, b=b) for c in "ifgo"},
                   **{f"b_h{c}": u(1, w, b=b) for c in "ifgo"}},
          "q_attn": {"w": u(w, w, b=w ** -0.5)},
          "e_attn": {"w": u(w, 1, b=w ** -0.5)}}
    x = (r(mask.shape[0], w) * mask).contiguous()
    s2v_leaves = [*rp["lstm"].values(), rp["q_attn"]["w"],
                  rp["e_attn"]["w"], x]
    for t in att_leaves + s2v_leaves:
        t.requires_grad_()
    s2v_args = (rp, x, mask, tb["node_graph"], tb["plan_graph_node_ptr"])
    return att_args, att_leaves, s2v_args, s2v_leaves


def _fwd_and_grads(fn, args, leaves, cw, kw):
    """fn's output and the gradient of Σ out·cw in every leaf."""
    import torch
    out = fn(*args, **kw)
    grads = torch.autograd.grad((out * cw).sum(), leaves, allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads)]


def _fwd_bwd_errors(got, want):
    """(forward ok, forward max abs error, backward ok, backward max error
    of the leaves scaled by their max abs)."""
    ok_f, err_f, _ = _within(got[0], want[0])
    ok_f = ok_f and bool(got[0].isfinite().all())
    ok_b, err_b = True, 0.0
    for a, b in zip(got[1], want[1]):
        scale = float(b.abs().max()) or 1.0
        ok, mabs, _ = _within(a / scale, b / scale)
        ok_b, err_b = ok_b and ok and bool(a.isfinite().all()), max(err_b,
                                                                    mabs)
    return ok_f, err_f, ok_b, err_b


def phase_att_kernel_check(device):
    """The four attention-family kernels against their plain versions on
    the card: adv widths (f 7, w 14) at batch 1024 and T 100 with the 'att'
    aggregation and the batch-global softmax, then 'adj', the per-graph
    softmax, T 3, and a ragged batch (single-atom molecules, padded edges,
    a padded graph slot)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import set2vec as S
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(41)
    b1024 = batch_to_device(_batch((SMILES * 103)[:1024], 1024), device)
    ragged = _ragged_att_batch(device)
    cases = [("batch1024 att/global T100", b1024, True, True, 100),
             ("batch1024 adj/global T100", b1024, False, True, 100),
             ("batch1024 att/per-graph T100", b1024, True, False, 100),
             ("batch1024 att/global T3", b1024, True, True, 3),
             ("ragged att/global T100", ragged, True, True, 100),
             ("ragged adj/per-graph T3", ragged, False, False, 3)]
    worst = dict.fromkeys(ATT_KERNELS, 0.0)
    results, failed = [], []
    for what, tb, corr, bsm, T in cases:
        aa, al, sa, sl = _att_case(tb, gen, device)
        n, g = int(tb["node_mask"].shape[0]), int(tb["graph_mask"].shape[0])
        cw = torch.randn(n, aa[0].shape[1], generator=gen).to(device)
        kw = dict(with_corr=corr)
        got = _fwd_and_grads(A.fused_att, aa, al, cw, kw)
        torch.cuda.synchronize()
        want = _fwd_and_grads(A.fused_att_reference, aa, al, cw, kw)
        ok1, ef1, ok2, eb1 = _fwd_bwd_errors(got, want)
        cw = torch.randn(g, 28, generator=gen).to(device)
        kw = dict(time_steps=T, batch_softmax=bsm)
        got = _fwd_and_grads(S.set2vec, sa, sl, cw, kw)
        torch.cuda.synchronize()
        want = _fwd_and_grads(S.set2vec_reference, sa, sl, cw, kw)
        ok3, ef2, ok4, eb2 = _fwd_bwd_errors(got, want)
        for name, err in zip(ATT_KERNELS, (ef1, eb1, ef2, eb2)):
            worst[name] = max(worst[name], err)
        ok = ok1 and ok2 and ok3 and ok4
        results.append(
            f"{what} (nodes {int(tb['node_mask'].sum())}/{n} slots, G={g}, "
            f"edges {int(tb['edge_mask'].sum())}/{tb['edge_src'].shape[0]}):"
            f" att fwd {ef1:.2e} bwd {eb1:.2e}, set2vec fwd {ef2:.2e} bwd "
            f"{eb2:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)
    print(f"att-kernel-check: fused_att_fwd/bwd vs fused_att_reference and "
          f"autograd through it, set2vec_fwd/bwd vs set2vec_reference and "
          f"autograd through it (cotangent Σ out·c; forward max abs error, "
          f"rtol {RTOL} atol {ATOL}; gradient leaves divided by their max "
          f"abs, max error, rtol {RTOL} atol {ATOL}): " + "; ".join(results),
          flush=True)
    if failed:
        raise RuntimeError(f"attention kernels disagree with their plain "
                           f"versions: {failed}")
    return worst


def _att_reset():
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import set2vec as S
    A.reset_launch_counts()
    S.reset_launch_counts()


def _att_counts():
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import set2vec as S
    return {**A.launch_counts, **S.launch_counts}


def phase_att_serve(device):
    """`predict --experiment adv_classification` as a user runs it, at
    batch 16 and 1024 from a seeded checkpoint; exactly one fused_att_fwd
    and one set2vec_fwd launch per request; logits against the plain path
    on the card, batch by batch (the batch-global softmax couples each
    batch's molecules). Returns the launch counts."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.trainer import batch_to_device
    os.makedirs(OUT_DIR, exist_ok=True)
    probe, ge = G.encode_molgraphs(G.generate_molgraphs(SMILES, [0] * 10))
    cfg = zoo.adv(ge.atom_width(), ge.bond_width(), n_out=PS_CLASSES)
    net = network_init(cfg, torch.Generator().manual_seed(43), "cpu")
    ckpt = os.path.join(OUT_DIR, "ckpt_adv.npz")
    save_checkpoint(ckpt, net, meta={"seed": 43, "model": "adv"})
    totals, lines = dict.fromkeys(ATT_KERNELS, 0), []
    for bs, rows in ((16, 64), (1024, 3072)):
        csv = _ps_csv("new_adv", rows)
        buf = io.StringIO()
        _att_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", ATT_EXP, "--data", csv,
                      "--ckpt", ckpt, "--batch-size", str(bs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _att_counts()
        recs = [json.loads(x) for x in buf.getvalue().splitlines() if x]
        n_req = -(-rows // bs)
        want = {"fused_att_fwd": n_req, "fused_att_bwd": 0,
                "set2vec_fwd": n_req, "set2vec_bwd": 0}
        if counts != want:
            raise RuntimeError(f"adv predict at batch {bs}: launches "
                               f"{counts}, the design's count is {want}")
        if len(recs) != rows or [r["index"] for r in recs] != list(
                range(rows)):
            raise RuntimeError(f"adv predict at batch {bs}: {len(recs)} "
                               f"records for {rows}")
        logits = torch.tensor([r["logits"] for r in recs],
                              dtype=torch.float64)
        if not torch.isfinite(logits).all() or any(
                r["pred"] != int(torch.argmax(lg))
                for r, lg in zip(recs, logits)):
            raise RuntimeError(f"adv predict at batch {bs}: non-finite "
                               "logits or a wrong argmax")
        for k in ATT_KERNELS:
            totals[k] += counts[k]
        gs, _, _, _ = G.load_classification_dataset(csv, "smiles", "target")
        pnet, _ = load_checkpoint(ckpt, net.cfg, device=device)
        with torch.no_grad():
            plain = torch.cat([
                network_apply_packed(pnet, batch_to_device(b, device),
                                     fused=False).cpu()
                for b in G.GraphLoader(gs, bs)]).to(torch.float64)
        ok, mabs, mrel = _within(logits, plain)
        lines.append(f"batch {bs}: {rows} molecules in {n_req} requests, "
                     f"launches fused_att_fwd {counts['fused_att_fwd']} "
                     f"set2vec_fwd {counts['set2vec_fwd']}, {wall:.2f} s "
                     f"wall (featurize+load+serve), logits vs plain path "
                     f"max_abs={mabs:.3e} max_rel={mrel:.3e} "
                     f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"adv batch {bs}: served logits disagree "
                               f"with the plain path ({mabs:.3e})")
    print("att-serve: " + "; ".join(lines), flush=True)
    return totals


def phase_att_train(device):
    """The `train` verb of adv_classification as a user runs it (2 epochs
    at batch 16 on a 4-class CSV), launch counts read around it: one
    launch of each forward and each backward per step, one of each
    forward per validation and test batch; the first 3 losses against the
    plain path on the card (rtol 1e-3), and the first step's logits and
    gradients against it (rtol 1e-4 of each one's max abs); then `predict`
    from the last checkpoint. Returns the launch counts."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train import cli, experiments
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import (batch_to_device, ce_loss,
                                              train_step)
    exp = experiments.get(ATT_EXP)
    csv = _ps_csv("train_adv", TRAIN_ROWS)
    log = os.path.join(OUT_DIR, "train_adv.jsonl")
    ckdir = os.path.join(OUT_DIR, "train_ckpt_adv")
    if os.path.exists(log):
        os.remove(log)
    buf = io.StringIO()
    _att_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--experiment", ATT_EXP, "--data", csv,
                  "--epochs", str(TRAIN_EPOCHS), "--ckpt-dir", ckdir,
                  "--log", log])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _att_counts()
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(log) as fh:
        recs = [json.loads(x) for x in fh if x.strip()]
    steps = [r["loss"] for r in recs if "step" in r]
    epochs = [r for r in recs if "train_loss" in r]
    gs, _, _, _ = G.load_classification_dataset(csv, "smiles", "target")
    bs = exp.train.batch_size
    train_gs, test_gs = train_test_split(gs, 0.1, 317)
    train_gs, val_gs = train_test_split(train_gs, 0.1, 317)
    n_steps = TRAIN_EPOCHS * -(-len(train_gs) // bs)
    n_eval = TRAIN_EPOCHS * -(-len(val_gs) // bs) + -(-len(test_gs) // bs)
    want = {"fused_att_fwd": n_steps + n_eval, "fused_att_bwd": n_steps,
            "set2vec_fwd": n_steps + n_eval, "set2vec_bwd": n_steps}
    if len(steps) != n_steps or counts != want:
        raise RuntimeError(f"adv train: {len(steps)} steps, launches "
                           f"{counts}; the design's count is {want}")
    if not (all(math.isfinite(x) for x in steps)
            and math.isfinite(result["test"]["loss"])
            and all(math.isfinite(r["val_loss"]) for r in epochs)):
        raise RuntimeError("adv train: non-finite loss")
    cfg = zoo.adv(int(gs[0].afm.shape[-1]), int(gs[0].bfm.shape[-1]),
                  n_out=PS_CLASSES)
    net = network_init(cfg, torch.Generator().manual_seed(317), device)
    opt = adam(net.parameters(), exp.train.learning_rate)
    plain = []
    for b in G.GraphLoader(train_gs, bs, shuffle=True, seed=317):
        if len(plain) == 3:
            break
        plain.append(float(train_step(net, opt, batch_to_device(b, device),
                                      fused=False, loss_kind="ce")))
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if rel > 1e-3:
        raise RuntimeError(f"adv train: first steps {steps[:3]} vs plain "
                           f"path {plain} (rel {rel:.2e})")
    # the losses sit near ln 4 and barely move: also hold the first step's
    # logits and every parameter gradient, kernels against the plain path,
    # on the trainer's initial weights and first batch, each divided by its
    # max abs (rtol RTOL, atol ATOL)
    tb = batch_to_device(next(iter(G.GraphLoader(train_gs, bs, shuffle=True,
                                                 seed=317))), device)
    net = network_init(cfg, torch.Generator().manual_seed(317), device)
    res = []
    for fused in (True, False):
        net.zero_grad(set_to_none=True)
        out, _ = network_apply_packed(net, tb, fused=fused, training=True)
        ce_loss(out, tb["labels"], tb["graph_mask"]).backward()
        res.append((out.detach(), [
            torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for p in net.parameters()]))
    scale = float(res[1][0].abs().max()) or 1.0
    ok_l, err_l, _ = _within(res[0][0] / scale, res[1][0] / scale)
    _, _, ok_g, err_g = _fwd_bwd_errors(res[0], res[1])
    if not (ok_l and ok_g):
        raise RuntimeError(f"adv train: first step vs plain path, logits "
                           f"{err_l:.2e}, gradients {err_g:.2e} (each divided"
                           f" by its max abs)")
    ckpt = os.path.join(ckdir, f"ckpt_{len(epochs) - 1}.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["predict", "--experiment", ATT_EXP, "--data", csv,
                  "--ckpt", ckpt])
    preds = [json.loads(x) for x in buf.getvalue().splitlines() if x]
    if len(preds) != TRAIN_ROWS or not all(
            math.isfinite(v) for r in preds for v in r["logits"]):
        raise RuntimeError(f"adv: predict from {ckpt} failed")
    print(f"att-train: {ATT_EXP}, {TRAIN_ROWS} molecules (train "
          f"{len(train_gs)}, val {len(val_gs)}, test {len(test_gs)}), batch "
          f"{bs}, {len(epochs)} epochs, {len(steps)} steps in {wall:.2f} s "
          f"wall; launches {counts} (design: each forward 1 per step and 1 "
          f"per eval batch, each backward 1 per step); step losses first "
          f"{steps[0]:.5f} last {steps[-1]:.5f}; epoch train loss sums "
          f"{[round(r['train_loss'], 4) for r in epochs]} (early stop below "
          f"{exp.train.early_stop_loss}); test f1 {result['test']['f1']:.4f};"
          f" first 3 steps vs plain path max rel {rel:.2e} (kernel "
          f"{[round(x, 6) for x in steps[:3]]}, plain "
          f"{[round(x, 6) for x in plain]}); first step's logits (max abs "
          f"{scale:.3e}) and {len(res[0][1])} parameter gradients vs plain "
          f"path, each divided by its max abs: {err_l:.2e}, {err_g:.2e} "
          f"(rtol {RTOL} atol {ATOL}); predict from "
          f"{os.path.basename(ckpt)}: {len(preds)} finite records",
          flush=True)
    return counts


def _att_bounds(b, f, w, k, T):
    """Least times of the four kernels' work on this batch, each the larger
    of its float32 operations over the peak CUDA-core rate and its bytes
    (each input read once, each output written once, set2vec's stash
    written by the forward and read by the backward) over HBM bandwidth.
    Real nodes and edges, every graph slot. The forwards as the serving
    path runs them (no message stash, no set2vec stash); a transcendental
    counts as one operation."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    gemv = 2 * f * 3 * f                            # f → 3f gate GEMV
    att_w = k * f * f + k * f + 2 * f * f + f + 2 * gemv // 2 + 6 * f
    edge_g = 5 * f + f + f                         # gate, g, Σ h0[u]
    node_g = (2 * f * f + f                        # h0·Wh, S_g
              + 5 * f + 2 * f                      # g0, X and g0 ⊙ X
              + 2 * gemv + 15 * f)                 # the GRU
    idx = er * 3 + nr + 1 + g + 1                  # vid, src, order, ptrs
    fwd = (er * (edge_g + 2 * f * f)               # + A'·g
           + nr * (node_g + 2 * f * f),            # + A0·(g0 ⊙ X)
           4 * (nr * f + idx + att_w + nr * f))
    # the backward recomputes the gates and the GRU's pre-activations
    # (edge_g, node_g), not the forward's products A'·g and A0·(g0 ⊙ X)
    edge_b = edge_g + 2 * f * f + 6 * f + 2 * f * f + f  # A'ᵀdm, VJPs, dA'
    node_b = (node_g + 2 * gemv + 20 * f           # GRU VJP: W_ihᵀ, W_hhᵀ
              + 2 * f * f + 8 * f + 2 * f * f      # correction VJP, dA0
              + 2 * f * f + 2 * f * f + 2 * gemv)  # dWh, Wh·dz, dW_ih/hh
    bwd = (er * edge_b + nr * node_b,
           4 * (3 * nr * f + idx + er + nr + 1 + att_w + nr * f + att_w))
    lstm = 4 * 2 * (2 * w) * w + 10 * w            # gates + cell, per graph
    step = g * (lstm + 2 * w * w) + nr * (4 * w + 3 + 2 * w)
    s2v_w = 8 * w * w + 4 * w + w * w + w
    stash = T * (3 * g * w + nr)
    s2v_f = (T * step, 4 * (nr * w + g + 1 + s2v_w + 2 * g * w))
    # per graph: the LSTM and q recomputed from the stashed carry, their
    # VJPs and leaf outer products; per node, the attention row stashed:
    # datt = dmr·x (2w), Σ datt·att and de (4), th = tanh(q + x) (2w),
    # ∂we (2w), dth (4w), ∂x (3w), dq (w)
    step_b = g * (lstm + 2 * w * w + 2 * 8 * w * w * 2 + 4 * w * w
                  + 12 * w) + nr * (14 * w + 4)
    s2v_b = (T * step_b, 4 * (nr * w + g + 1 + s2v_w + stash + 2 * g * w
                              + nr * w + s2v_w))
    out = {}
    for name, (ops, nbytes) in zip(ATT_KERNELS, (fwd, bwd, s2v_f, s2v_b)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def phase_att_times(device, card):
    """adv at batch 16 and 1024: request latency and train-step latency
    (host clock ending in a device sync), each kernel's time (CUDA events
    over repeated launches on the main path's inputs) beside its bound and
    its plain version's, and the device idle share of one profiled
    batch-1024 train step."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import set2vec as S
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.fused_train import _build_att_form
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch,
                                              train_step)
    out, lines = {}, []
    gen = torch.Generator().manual_seed(47)
    for bs in (16, 1024):
        b = _batch((SMILES * (bs // len(SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randint(0, PS_CLASSES, (bs,),
                                    generator=gen).numpy()
        tb = batch_to_device(b, device)
        cfg = zoo.adv(b["node_feats"].shape[1], b["edge_feats"].shape[1],
                      n_out=PS_CLASSES)
        net = network_init(cfg, gen, device)
        opt = adam(net.parameters(), 1e-3)
        reps = 20
        for _ in range(3):
            float(train_step(net, opt, tb, loss_kind="ce"))
        step_lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(train_step(net, opt, tb, loss_kind="ce"))
            torch.cuda.synchronize()
            step_lat.append((time.perf_counter() - t0) * 1e3)
        estep = eval_step_for_batch(cfg, "ce", b)

        def request():
            _, o = estep(net, batch_to_device(b, device))
            o.cpu()
            torch.cuda.synchronize()
        for _ in range(3):
            request()
        req_lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            request()
            req_lat.append((time.perf_counter() - t0) * 1e3)
        busy = None
        if bs == 1024:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                float(train_step(net, opt, tb, loss_kind="ce"))
                torch.cuda.synchronize()
            busy, ops = _device_ops(prof)
            with open(os.path.join(OUT_DIR, "profile_att_train_1024.txt"),
                      "w") as fh:
                fh.write(prof.key_averages().table(
                    sort_by="self_device_time_total", row_limit=40))
            kern = {k: sum(getattr(e, "self_device_time_total", 0.0)
                           for e in ops if f"{k}_kernel" in e.key)
                    for k in ATT_KERNELS}
            if min(kern.values()) <= 0:
                raise RuntimeError(f"att-times: no device time for {kern}")
        # the kernels alone, on the inputs the main path gives them
        mpnn = net.mpnn
        with torch.no_grad():
            mask, ng = tb["node_mask"], tb["node_graph"]
            h0 = (tb["node_feats"] * mask).contiguous()
            aprime, a0, qv, q0, wh = _build_att_form(mpnn, tb)
            gru = {k: v.detach() for k, v in mpnn.gru.as_dict().items()}
            plan = plan_from_batch(tb)
            weights = list(zip(A._GRAD_LEAVES, (
                aprime, a0, qv, q0.detach(), wh, gru["w_ih"], gru["w_hh"],
                gru["b_ih"], gru["b_hh"])))
            att_in = (weights, h0, mask, ng, tb["edge_vid"], tb["edge_src"],
                      tb["edge_dst"], plan)
            pe = A.prepare_fused_att_fwd(*att_in, with_corr=True,
                                         write_msgs=False)
            pt = A.prepare_fused_att_fwd(*att_in, with_corr=True,
                                         write_msgs=True)
            ref = (aprime, a0, qv, q0, wh, h0, mask, ng, gru,
                   tb["edge_vid"], tb["edge_src"], tb["edge_dst"], plan)
            times = {"fused_att_fwd": _events_ms(
                lambda: K.launch_prepared(pe), 100)}
            t_train = {"fused_att_fwd": _events_ms(
                lambda: K.launch_prepared(pt), 100)}
            plain = {"fused_att_fwd": _events_ms(
                lambda: A.fused_att_reference(*ref), 10)}
            h, msgs = K.launch_prepared(pt)
            gh = torch.randn(h.shape, generator=gen).to(device)
            pb = A.prepare_fused_att_bwd(weights, h0, msgs, gh,
                                         tb["edge_vid"], tb["edge_src"],
                                         tb["edge_dst"], plan,
                                         with_corr=True)
            times["fused_att_bwd"] = _events_ms(
                lambda: K.launch_prepared(pb), 100)
            x = torch.cat([h, h0], -1).contiguous()
            ro = mpnn.readout.as_jax()
            leaves = [t.detach() for t in S.flat_leaves(ro)]
            meta = S.S2vMeta(cfg.mpnn.set2vec_steps,
                             cfg.mpnn.set2vec_batch_softmax)
            gnp = tb["plan_graph_node_ptr"]
            se = S.prepare_set2vec_fwd(leaves, x, mask, ng, gnp, meta,
                                       stash=False)
            st = S.prepare_set2vec_fwd(leaves, x, mask, ng, gnp, meta,
                                       stash=True)
            times["set2vec_fwd"] = _events_ms(
                lambda: K.launch_prepared(se), 20)
            t_train["set2vec_fwd"] = _events_ms(
                lambda: K.launch_prepared(st), 20)
            m, carry, att = K.launch_prepared(st)
            gm = torch.randn(m.shape, generator=gen).to(device)
            sb = S.prepare_set2vec_bwd(leaves, x, gnp, carry, att, gm, meta)
            times["set2vec_bwd"] = _events_ms(
                lambda: K.launch_prepared(sb), 20)
            rp = {"lstm": dict(zip(S._GRAD_LEAVES[:8], leaves[:8])),
                  "q_attn": {"w": leaves[8]}, "e_attn": {"w": leaves[9]}}
            skw = dict(time_steps=meta.steps,
                       batch_softmax=meta.batch_softmax)
            plain["set2vec_fwd"] = _events_ms(lambda: S.set2vec_reference(
                rp, x, mask, ng, gnp, **skw), 5)
        a_leaves = [t.requires_grad_() for _, t in weights] + [
            h0.requires_grad_()]
        g_ref = {k: v for k, v in zip(("w_ih", "w_hh", "b_ih", "b_hh"),
                                      a_leaves[5:9])}
        h_ref = A.fused_att_reference(*a_leaves[:5], h0, mask, ng, g_ref,
                                      tb["edge_vid"], tb["edge_src"],
                                      tb["edge_dst"], plan)
        obj = (h_ref * gh).sum()
        plain["fused_att_bwd"] = _events_ms(lambda: torch.autograd.grad(
            obj, a_leaves, retain_graph=True), 5)
        s_leaves = [t.requires_grad_() for t in leaves] + [
            x.requires_grad_()]
        rp = {"lstm": dict(zip(S._GRAD_LEAVES[:8], s_leaves[:8])),
              "q_attn": {"w": s_leaves[8]}, "e_attn": {"w": s_leaves[9]}}
        m_ref = S.set2vec_reference(rp, x, mask, ng, gnp, **skw)
        obj = (m_ref * gm).sum()
        plain["set2vec_bwd"] = _events_ms(lambda: torch.autograd.grad(
            obj, s_leaves, retain_graph=True), 3, warm=1)
        bounds = _att_bounds(b, cfg.mpnn.node_features,
                             2 * cfg.mpnn.node_features, aprime.shape[0],
                             cfg.mpnn.set2vec_steps)
        rec = {"step_ms": statistics.median(step_lat),
               "request_ms": statistics.median(req_lat)}
        for name in ATT_KERNELS:
            rec[name] = dict(ms=times[name], plain_ms=plain[name],
                             bound_ms=bounds[name][0],
                             bound_by=bounds[name][1])
        out[bs] = rec
        idle = "" if busy is None else (
            f"; one train step's device busy {busy:.1f} us in "
            f"{sum(e.count for e in ops)} device ops, idle share "
            f"{1 - busy / (rec['step_ms'] * 1e3):.3f}, kernels in the trace "
            + ", ".join(f"{k} {v:.1f} us" for k, v in kern.items()))
        lines.append(
            f"adv batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}, vocab {aprime.shape[0]}): request "
            f"median {rec['request_ms']:.3f} ms, train step median "
            f"{rec['step_ms']:.3f} ms ({reps} reps each){idle}; "
            + ", ".join(
                f"{name} {times[name] * 1e3:.2f} us (events"
                + (f"; with the training stash {t_train[name] * 1e3:.2f} us"
                   if name in t_train else "")
                + f"), plain {plain[name] * 1e3:.1f} us, bound "
                f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.2f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in ATT_KERNELS))
    print(f"att-times [{card}]: " + "; ".join(lines), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    worst = phase_kernel_check(device)
    launches, runs = phase_serve(device)
    times = phase_times(device, card, runs)
    phase_profile(device, runs, times[1024]["request_ms"])
    train_counts = phase_train(device)
    ttimes = phase_train_times(device, card)
    phase_train_profile(device, ttimes[1024]["step_ms"])
    ps_worst = phase_ps_kernel_check(device)
    ps_launches = phase_ps_serve(device)
    ps_counts = phase_ps_train(device)
    ps_times = phase_ps_times(device, card)
    ps_counts["fused_psteps_eval"] += ps_launches
    att_worst = phase_att_kernel_check(device)
    att_counts = phase_att_serve(device)
    for k, v in phase_att_train(device).items():
        att_counts[k] += v
    att_times = phase_att_times(device, card)
    t = times[1024]
    kernels = [{
        "name": "fused_eval", "route": "cuda",
        "source": "mpnn_tpu_torch/csrc/fused_eval.cu",
        "replaces": "mpnn_tpu/kernels/fused_step.py:374",
        "launches": launches, "max_abs_err": worst["fused_eval"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]
    for name, line in (("fused_step_fwd", 232), ("fused_step_bwd", 668)):
        tt = ttimes[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/fused_step.py:{line}",
            "launches": train_counts[name], "max_abs_err": worst[name],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    for name, line in zip(PS_KERNELS, (1254, 195, 428)):
        tt = ps_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/fused_psteps.py:{line}",
            "launches": ps_counts[name], "max_abs_err": ps_worst[name],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    att_sites = {"fused_att_fwd": "fused_att.py:77",
                 "fused_att_bwd": "fused_att.py:157",
                 "set2vec_fwd": "set2vec.py:84",
                 "set2vec_bwd": "set2vec.py:180"}
    for name in ATT_KERNELS:
        tt = att_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/{att_sites[name]}",
            "launches": att_counts[name], "max_abs_err": att_worst[name],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
