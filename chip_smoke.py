#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mpnn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. device  — nvidia-smi name and power limit, torch/CUDA versions;
  2. build   — nvcc of every kernel source in mpnn_tpu_torch/csrc/, with
               ptxas' register / shared-memory / spill report;
  3. kernel-check — each CUDA kernel against its plain PyTorch version on
               the card: flagship lipo widths at batch 1024 for every
               msg/state norm pair in {bn1d, none}², and a ragged batch
               with padded edges and single-atom molecules
               (rtol 1e-4, atol 1e-5: float32 sums in other orders);
  4. serve   — the `predict` verb from SMILES (bench.py's ten molecules,
               repeated) at batch 16 and 1024 with a checkpoint built from
               a seeded torch.Generator; launch counts read around it;
               predictions checked finite and against the plain path;
  5. times   — request latency (host clock ending in a device sync) and
               the kernel's time (CUDA events) beside its bound and its
               plain version's time;
  6. profile — torch.profiler trace of one batch-1024 request: device
               busy time, the kernel's share and the device idle share.
Then the `kernels` JSON line, and last {"ok": true, "device": {...}}.
Files it writes go to $MPNN_SMOKE_OUT (default ./smoke_out/).
Any failure exits non-zero without the last line. Needs one card and
imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
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
                entry = f"<{t.group(1)},{t.group(2)}>" if t else m.group(1)
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
    # the kernel's weights live in dynamic shared memory, which ptxas does
    # not see: the launch's size at the flagship vocab of 16
    dyn = K._lib().mpnn_fused_eval_smem_bytes(16)
    print(f"build: {wall:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())});"
          f" ptxas: {'; '.join(report)}; fused_eval dynamic smem {dyn} B "
          f"per block at K=16", flush=True)


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
    return worst, flag


def _serving_net(gen, afm, bfm, nafm, device):
    import torch
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    net = network_init(zoo.lipo(afm, bfm, nafm), gen, "cpu")
    with torch.no_grad():
        for mod in net.modules():
            if hasattr(mod, "running_var"):
                f = mod.weight.shape[0]
                mod.weight.copy_(1 + 0.2 * torch.randn(f, generator=gen))
                mod.bias.copy_(0.2 * torch.randn(f, generator=gen))
                mod.running_mean.copy_(0.3 * torch.randn(f, generator=gen))
                mod.running_var.copy_(0.3 + torch.rand(f, generator=gen))
        mb = net.mpnn.message[0].message_bias
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
    net = _serving_net(gen, afm, bfm, nafm, "cpu")
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


def phase_profile(device, runs, request_ms):
    """Device-time breakdown of one batch-1024 request: busy time = the
    sum of the request's device kernels and copies; the idle share compares
    it with the unprofiled request median. Fails when the trace shows no
    device time for the kernel."""
    import torch
    from torch.autograd import DeviceType
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
    ops = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(dev(e) for e in ops)
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
    worst, _ = phase_kernel_check(device)
    launches, runs = phase_serve(device)
    times = phase_times(device, card, runs)
    phase_profile(device, runs, times[1024]["request_ms"])
    t = times[1024]
    print(json.dumps({"kernels": [{
        "name": "fused_eval", "route": "cuda",
        "source": "mpnn_tpu_torch/csrc/fused_eval.cu",
        "replaces": "mpnn_tpu/kernels/fused_step.py:374",
        "launches": launches, "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
