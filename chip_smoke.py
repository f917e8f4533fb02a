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
               each gradient leaf scaled by its max abs; the backward on
               every route of its rule (one cluster of 1, 2, 4 and 8
               blocks, the grid, the grid with tiles smaller than the
               graphs) at b1024, b16 and ragged, each run twice for the
               same bits;
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
               version's time; the backward's route, its empty-walk
               floor (the same grid and combines, no arithmetic) and
               block 0's clock64 phases;
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
               T 3, and a ragged batch with a padded graph slot; then
               set2vec's every route in both modes, its tags asserted
               (one block, a block per SM, chunked rows, the backward's
               leaf sums and both kernels' slots in global scratch: w
               14-64, up to 10,000 graphs);
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
               and the b1024 train step's device idle share;
 18. atts-kernel-check — the T-step attention model's two kernels
               (fused_att_steps fwd/bwd) against their plain versions on the
               card (rtol 1e-4, atol 1e-5; gradient leaves scaled by their
               max abs; each case also through the serving launch): att
               widths (f 7, T 3) at batch 1024 in the four modes (per-step
               or shared message tables, stateless norm or none, adj or
               att), and a ragged batch with a padded graph slot;
 19. atts-serve — `predict --experiment att_classification` at batch 16
               and 1024 from a seeded checkpoint: one fused_att_steps_fwd
               and one set2vec_fwd launch per request, logits against the
               plain path on the same batches;
 20. atts-train — its `train` verb, 2 epochs at batch 16: one launch of
               each forward and backward per step, the first 3 losses
               against the plain path (rtol 1e-3), the first step's logits
               and every parameter gradient against it (each divided by
               its max abs; rtol 1e-4, atol 1e-5), `predict` from the
               checkpoint it wrote;
 21. atts-times — request and train-step latency at batch 16 and 1024,
               both kernels' times beside their bounds and their plain
               versions', and the b1024 train step's device idle share.
 22. mlp-kernel-check — the edge-MLP chain kernels (edge_mlp fwd/bwd, the
               ×50 tail every model's A-form build runs once per message
               network) against their plain version on the card: each
               model's chain at its b1024 vocab rows, and pf 16, 49, 64,
               81, 144, 256, 484 and 625 and the zero row alone — every
               route of the launch rule: registers in one block and in
               several, W_s panels in one block and in clusters of 2 and
               4, W_s from device memory in clusters of 8 (rtol 1e-4,
               atol 1e-5 of each output's or leaf's max abs). Phases 4, 7,
               11, 12, 15, 16, 19 and 20 also check their edge-MLP
               launches: one forward per message network per forward
               launch of the model's kernels, one backward per message
               network per backward launch;
 23. mlp-times — both chain kernels' times (events; beside them the
               device time in a trace) at those shapes beside their
               bounds and the plain chain's time, the empty-chain floor of
               each launch (its grid and barriers, no work) and block 0's
               clock64 phases of a tail layer (loads, dot, barrier) and,
               in the backward, of the ∂W product;
 24. wide  — lipo, graph_norm, adv and att from SMILES that featurize to
               afm 27 (f 27-30, od up to 108, set2vec w 54): `predict` and
               the `train` verb through every family's wide width bucket,
               launch counts, the plain path (predictions, first 3 losses,
               the first step's outputs and gradients), each kernel's
               device time in a trace; lipo's wide backward on every
               route of its rule; lipo at f 33 raises;
 25. bil-kernel-check — the bilinear family's two kernels (fused_bilinear
               fwd/bwd) against their plain versions on the card (rtol
               1e-4, atol 1e-5; h0 and GRU gradients scaled by their max
               abs; each case also through the serving launch, no message
               stash): ecfp_bilinear's batch of 1024 (f 2, T 2, its own A
               table), random non-symmetric tables at f 2-4, T 1-3, and a
               ragged batch with a padded graph slot;
 26. bil-serve — ecfp_bilinear (reached as the reference reaches it: nf 2,
               bond rows of width 8, ECFP labels at 32 bits) served through
               the API's predict_batches at batch 128 and 1024: one
               forward launch per request, outputs against the plain path;
 27. bil-train — ecfp_bilinear through train/trainer.py::train (ecfp_mse,
               2 epochs at batch 128): one forward and one backward launch
               per step, one forward per validation batch, the first 3
               losses against the plain path (rtol 1e-3);
 28. bil-times — request and train-step latency at batch 128 and 1024,
               both kernels' times beside their bounds and their plain
               versions';
 29. ecfp  — encoded_ecfp (the reference's ECFP script) through `predict`
               (batch 128 and 1024) and `train` (batch 128, 2 epochs) on
               its own SMILES CSV at 16,384 bits: the per-step kernels'
               and edge-MLP launch counts, the first logits and the first
               3 losses against the plain path, obn's running statistics
               moved, and the ECFP batch's host collation and
               host-to-device time.
 30. spmm-kernel-check — the SpMM kernels (spmm_fwd: the forward and, on
               Aᵀ through the source order, the VJP's dh; spmm_da: dA)
               against their plain version under autograd: lipo's b1024
               batch in 16,512 node slots at f 10 (its own vocab) and at
               f 30 with 64 vocab ids, a ragged batch, b16 and 32,896
               slots (rtol 1e-4, atol 1e-5; dA and dh divided by their
               max abs);
 31. rec-kernel-check — the fused recurrence kernels (recurrence_fwd,
               recurrence_bwd) against the plain chain under autograd at
               T 6, f 10 and 30, at b16's, 16,512 and 32,896 node slots,
               a random mask: h_T, the statistics and every gradient leaf
               (scaled), and the serving launch;
 32. dec-train — the decomposed training path: `train --spmm kernel` on
               lipo (2 epochs at 16; `predict` from its checkpoint),
               trainer.train(fuse_step=False, fuse_recurrence=True),
               `train --spmm kernel` of graph_norm_classification, and
               lipo at afm 27 — each run's exact launch counts, its first
               3 losses against the plain path (rtol 1e-3) and the first
               step's parameter gradients (scaled, 1e-4 / 1e-5);
 33. dec-times — the decomposed lipo train step at batch 16 and 1024
               beside the whole-step path's in the same run, the four new
               kernels' times beside their bounds and plain versions'
               (b1024), and the decomposed step's device idle share.
 34. sddmm-kernel-check — the attention SDDMM kernels (sddmm_fwd,
               sddmm_bwd) against their plain version under autograd on
               the tile rule's tiles and on the smallest tiles (a lane
               group one position, long rows over many tiles): adv's b1024
               batch in 16,512 node slots (f 7, its own vocab), f 27 and
               f 32 with 64 vocab ids, mf 13 at nf 10, a hub node of 400
               edges, a ragged batch, b16 and 32,896 slots, every case
               with aprime[0], h and the cotangent random at the dummy
               node (rtol 1e-4, atol 1e-5; the five gradients divided by
               their max abs; a second run gives the same bits);
 35. dec-att-train — the attention models' decomposed path: `train
               --spmm kernel` and trainer.train(fuse_step=False) on adv
               and att (1 epoch at 16), att at afm 27 — each run's exact
               launch counts (per step and message network 1 + 1 SDDMM
               and chain launches, 1 + 1 set2vec), its first 3 losses
               against the plain path (rtol 1e-3) and the first step's
               parameter gradients (scaled, 1e-4 / 1e-5);
 36. dec-att-times — the decomposed adv and att train steps at batch 16
               and 1024 beside the whole-step path's in the same run, the
               b1024 steps' device idle share from a trace, and both SDDMM
               kernels' times at adv b16 and b1024 (events; the trace's
               device time beside them) with their bounds, plain
               versions', routes, empty-kernel floors, clock64 phases
               and times on the real edges alone.
 37. split-kernel-check — the split training backward's kernels (ro_bwd,
               msg_bwd, ps_walk_bwd; kernels/split_bwd.py) against their
               plain versions: b1024 in 16,512 slots and b3584 in 57,856,
               lipo's widths (T 1) and the per-step family's (T 3) with
               every msg × state norm pair, graph_norm's, the wide bucket
               (f 27-32, od 60-128, 64 vocab ids), a ragged batch and b16,
               every case with its inputs random at the padded node slots
               (each output divided by its max abs; rtol 1e-4 / atol 1e-5);
 38. split-train — lipo through `train --batch-size 3584`, encoded_
               classification and graph_norm_classification through
               trainer.train at 3584 (1 epoch on 9,000 of bench.py's
               molecules, the loader's node cap its worst batch): the node
               slots, the `auto` route's exact launch counts (per step 1
               ro_bwd, 1 msg_bwd, 1 recurrence_bwd or ps_walk_bwd; no
               whole-step backward), the first 3 losses against the plain
               path (rtol 1e-3), the first step's gradients against the
               plain model in float64 (scaled, 1e-4 / 1e-5); one step of
               each at b1024 on the whole route;
 39. split-times — lipo and encoded at b1024 (split forced) and b3584
               (split by the rule): each split kernel's time beside its
               bound and its plain version's, the whole route's backward
               beside the split route's three launches, both routes'
               train-step latency, and at b3584 their device busy time and
               idle share.
 40. basic-kernel-check — rows 1-3 with the stateless state norm
               ((none, stateless) and (bn1d, stateless); its serving launch
               is the cooperative fused_eval_stateless) and in every width
               bucket of the shared family ('', o64, f32, o128) against
               their plain versions: lipo's widths at b1024 in 16,512 slots
               and 2,560 molecules in 32,896 slots, ragged; the basic
               shell's at b1024, b16 and with 64 vocab ids; at afm 27 (od
               108) at b1024; h0 random at the padded node slots (rtol
               1e-4, atol 1e-5; gradient leaves scaled by their max abs);
               the backward's routes in every bucket, twice each for the
               same bits;
 41. basic  — basic_classification through `predict` (batch 16 and 1024)
               and `train`, single_target through `predict` and `train` on
               a 250-class CSV (one-vs-rest against class 243), the
               autoencoder and the two stateless shared pairs through
               trainer.train and the eval step: exact launch counts, first
               3 losses against the plain path (rtol 1e-3), outputs and
               first-step gradients against it; basic at afm 27 runs in
               phase 24;
 42. basic-times — rows 1-3 in the stateless mode at lipo's widths, the
               basic shell's in the o64 build and forced into the f32 one,
               and at afm 27 in the o128 build (b1024): CUDA-event times
               beside their bounds and plain versions'.
Then the `kernels` JSON line, and last {"ok": true, "device": {...}}.
Files it writes go to $MPNN_SMOKE_OUT (default ./smoke_out/).
Any failure exits non-zero without the last line. Needs one card and
imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
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


# the edge-MLP chain kernels' launches on the main paths (the serve and
# train phases of every model), summed; each of those phases checks its
# own count: one forward per message network per forward launch of the
# model's kernels, one backward per message network per backward launch
MLP_KERNELS = ("edge_mlp_fwd", "edge_mlp_bwd")
MLP_MAIN = dict.fromkeys(MLP_KERNELS, 0)


def _nets(cfg):
    """Message networks (each with its own edge-MLP chain) of a config."""
    return 1 if cfg.share_message_weights else cfg.message_steps


def _mlp_reset():
    from mpnn_tpu_torch.kernels import edge_mlp as M
    M.reset_launch_counts()


def _mlp_take(what, nets, fwd, bwd):
    """Check the edge-MLP launches since _mlp_reset() against `nets`
    message networks times the model kernels' `fwd` forward and `bwd`
    backward launches; add them to MLP_MAIN; return them."""
    from mpnn_tpu_torch.kernels import edge_mlp as M
    want = {"edge_mlp_fwd": nets * fwd, "edge_mlp_bwd": nets * bwd}
    got = dict(M.launch_counts)
    if got != want:
        raise RuntimeError(f"{what}: edge-MLP launches {got}, the design's "
                           f"count is {want} ({nets} message networks)")
    for k, v in got.items():
        MLP_MAIN[k] += v
    return got


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


def _lib_call(module, name, fn, *args):
    """fn(*args) of the loaded library `name` of kernels/<module>.py."""
    import importlib
    mod = importlib.import_module(f"mpnn_tpu_torch.kernels.{module}")
    return getattr(mod._lib(name), fn)(*args)


def phase_build():
    import torch
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
                k = re.search(
                    r"\d((?:fused|set2vec|edge_mlp|spmm|recurrence|ro|"
                    r"ps_walk|graph_sums|node|item|combine)(?:_[a-z_]+)?"
                    r"_kernel)[EIv]",
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
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import set2vec as S
    atts_fwd = AS._lib("fused_att_steps_fwd") \
        .mpnn_fused_att_steps_fwd_smem_bytes(3, 16, 3)
    atts_cap = K.tile_capacity(AS._tile_floats("", 3, 16, 3), torch.cuda
                               .get_device_properties(0)
                               .shared_memory_per_block_optin, AS.MAX_NCAP)
    atts_bwd = AS._lib("fused_att_steps_bwd") \
        .mpnn_fused_att_steps_bwd_smem_bytes(3, 16, 3, atts_cap,
                                             AS.EDGE_RATIO * atts_cap)
    if atts_bwd != 4 * AS.bwd_smem_floats("", 3, 16, 3, atts_cap,
                                          AS.EDGE_RATIO * atts_cap):
        raise RuntimeError("fused_att_steps_bwd: the library's shared "
                           "memory disagrees with bwd_smem_floats")
    att_bwd = A._lib("fused_att_bwd").mpnn_fused_att_bwd_smem_bytes(
        16, 2 * A.BWD_NODES, 2 * A.BWD_NODES * A.EDGE_RATIO)
    if att_bwd != 4 * A.bwd_smem_floats("", 16, 2 * A.BWD_NODES):
        raise RuntimeError("fused_att_bwd: the library's shared memory "
                           "disagrees with bwd_smem_floats")
    from mpnn_tpu_torch.kernels import recurrence as R
    rec = R.device_fwd_shape(16512, "", 6, 0)
    if rec.smem_bytes != _lib_call(
            "recurrence", "recurrence_fwd", "mpnn_recurrence_fwd_smem_bytes",
            6, rec.ncap, rec.grid):
        raise RuntimeError("recurrence_fwd: the library's shared memory "
                           "disagrees with fwd_smem_floats")
    eval_cap = 2 * K.EVAL_NODES
    eval_smem = K._lib().mpnn_fused_eval_smem_bytes(16, 6, eval_cap,
                                                    K.EDGE_RATIO * eval_cap)
    if eval_smem != 4 * K.eval_smem_floats("", 16, 6, eval_cap):
        raise RuntimeError("fused_eval: the library's shared memory "
                           "disagrees with eval_smem_floats")
    dyn = (f"fused_eval {eval_smem} B (T 6, a tile of {eval_cap} nodes), "
           f"fused_step_fwd and fused_eval_stateless {_fwd_smem_line()}, "
           f"fused_step_bwd {_bwd_smem_line()} (T 6); fused_psteps_eval "
           f"{P._lib('fused_psteps_eval').mpnn_fused_psteps_eval_smem_bytes(3)}"
           " B (T 3; its A tables stay in device memory, any K); "
           f"fused_psteps_fwd {_ps_fwd_smem_line()}; "
           f"{_walk_smem_line()}; "
           + f"fused_att_fwd {A._lib('fused_att_fwd').mpnn_fused_att_fwd_smem_bytes(16)}"
           f" B (K 16), fused_att_bwd {att_bwd} B (K 16, a tile of "
           f"{2 * A.BWD_NODES} nodes); " + ", ".join(
               f"set2vec_{d} {S.device_shape(d, n, g, 14, 0).smem} B"
               for d in ("fwd", "bwd") for n, g in ((258, 16),
                                                     (16512, 1024)))
           + " (w 14 at b16's one block, b1024's block per SM); "
           f"fused_att_steps_fwd {atts_fwd} B (its A' tables stay in "
           f"device memory), fused_att_steps_bwd {atts_bwd} B ({atts_cap} "
           "nodes a block, A'_t staged; Tm 3, K 16, T 3, f 7); "
           + ", ".join(
               f"{n} {getattr(B._lib(n), f'mpnn_{n}_smem_bytes')(16, 32)} B"
               for n in ("fused_bilinear_fwd", "fused_bilinear_bwd"))
           + " (K 16, graphs up to 32 atoms); spmm_fwd "
           f"{_lib_call('spmm', 'spmm_fwd', 'mpnn_spmm_fwd_smem_bytes', 16, 16, 8)}"
           f" B (K 16, a tile of 128 positions; the wide bucket stages up "
           f"to 16 ids' tables, past them it reads A from device memory), "
           f"spmm_da "
           f"{_lib_call('spmm', 'spmm_da', 'mpnn_spmm_da_smem_bytes')} B, "
           f"recurrence_fwd {rec.smem_bytes} B (T 6, f 10, b1024's "
           f"{rec.tag()}); "
           f"ro_bwd {_lib_call('readout_bwd', 'ro_bwd', 'mpnn_ro_bwd_smem_bytes')}"
           f" B, ps_walk_bwd "
           f"{_lib_call('psteps_walk', 'ps_walk_bwd', 'mpnn_ps_walk_bwd_smem_bytes', 3)}"
           " B (T 3), msg_bwd 2·128·16 floats (its item launch)")
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


def _bwd_smem_line():
    """fused_step_bwd's node capacity and dynamic shared memory per bucket
    (K 16, T 6) on this card, each held against the library's own layout
    (kernels/fused_step.py::bwd_smem_floats mirrors csrc's Smem)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    out = []
    for tag, _ in K.BUCKETS:
        cap = K.bwd_capacity(tag, 16, 6, smem)
        lib = K._lib("fused_step_bwd", tag=tag)
        for c in (1, cap):
            want = 4 * K.bwd_smem_floats(tag, 16, 6, c, K.EDGE_RATIO * c)
            got = lib.mpnn_fused_step_bwd_smem_bytes(16, 6, c,
                                                     K.EDGE_RATIO * c)
            if got != want:
                raise RuntimeError(f"fused_step_bwd.{tag}: the library "
                                   f"takes {got} B at {c} nodes, "
                                   f"bwd_smem_floats {want}")
        out.append(f"{tag or 'narrow'} {cap} nodes a block, {want} B")
    return ", ".join(out)


def _walk_smem_line():
    """fused_psteps_bwd's (K 16, T 3) and recurrence_bwd's (T 6) node
    capacity and dynamic shared memory per bucket on this card, each held
    against the library's own layout (bwd_smem_floats of kernels/
    fused_psteps.py and kernels/recurrence.py mirror csrc's Smem)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import recurrence as R
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    out = []
    for tag, _ in P.BUCKETS:
        cap = P.bwd_capacity(tag, 16, 3, smem)
        lib = P._lib("fused_psteps_bwd", tag)
        for c in (1, cap):
            e = P.EDGE_RATIO * c
            want = 4 * P.bwd_smem_floats(tag, 16, 3, c, e)
            got = lib.mpnn_fused_psteps_bwd_smem_bytes(16, 3, c, e)
            if got != want:
                raise RuntimeError(f"fused_psteps_bwd.{tag}: the library "
                                   f"takes {got} B at {c} nodes, "
                                   f"bwd_smem_floats {want}")
        out.append(f"fused_psteps_bwd {tag or 'narrow'} {cap} nodes a "
                   f"block, {want} B")
    for tag, _ in R.BUCKETS:
        cap = R.bwd_capacity(tag, 6, smem)
        lib = R._lib("recurrence_bwd", tag)
        for c in (1, cap):
            want = 4 * R.bwd_smem_floats(tag, 6, c)
            got = lib.mpnn_recurrence_bwd_smem_bytes(6, c)
            if got != want:
                raise RuntimeError(f"recurrence_bwd.{tag}: the library "
                                   f"takes {got} B at {c} nodes, "
                                   f"bwd_smem_floats {want}")
        out.append(f"recurrence_bwd {tag or 'narrow'} {cap} nodes a block, "
                   f"{want} B")
    return ", ".join(out) + " (K 16, T 3; T 6)"


def _fwd_smem_line():
    """The forward kernels' node capacity and dynamic shared memory per
    bucket (K 16, T 6) on this card, each held against both libraries' own
    layout (kernels/fused_step.py::fwd_smem_floats mirrors csrc's Smem)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    out = []
    most = torch.cuda.get_device_properties(0).multi_processor_count
    for tag, _ in K.BUCKETS:
        cap = K.fwd_capacity(tag, 16, 6, smem, most)
        libs = ((K._lib("fused_step_fwd", tag=tag),
                 "mpnn_fused_step_fwd_smem_bytes"),
                (K._lib("fused_eval", tag=tag),
                 "mpnn_fused_eval_stateless_smem_bytes"))
        for c, blocks in ((1, 1), (1, 8), (cap, most)):
            want = 4 * K.fwd_smem_floats(tag, 16, 6, c, K.EDGE_RATIO * c,
                                         blocks)
            for lib, fn in libs:
                got = getattr(lib, fn)(16, 6, c, K.EDGE_RATIO * c, blocks)
                if got != want:
                    raise RuntimeError(f"{fn}.{tag}: the library takes {got}"
                                       f" B at {c} nodes, fwd_smem_floats "
                                       f"{want}")
        out.append(f"{tag or 'narrow'} {cap} nodes a block, {want} B "
                   f"(grid of {most})")
    return ", ".join(out)


def _ps_fwd_smem_line():
    """fused_psteps_fwd's node capacity and dynamic shared memory per
    bucket (K 8 and 64, T 3) on this card, each held against the
    library's own layout (kernels/fused_psteps.py::fwd_smem_floats
    mirrors csrc's Smem)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    props = torch.cuda.get_device_properties(0)
    smem, most = (props.shared_memory_per_block_optin,
                  props.multi_processor_count)
    out = []
    for tag, _ in P.BUCKETS:
        lib = P._lib("fused_psteps_fwd", tag)
        for k in (8, 64):
            cap = P.fwd_capacity(tag, k, 3, smem, most)
            staged = P.amat_in_smem(tag, k, 3)
            for c, blocks in ((1, 1), (1, 8), (cap, most)):
                want = 4 * P.fwd_smem_floats(tag, k, 3, c, P.EDGE_RATIO * c,
                                             blocks)
                got = lib.mpnn_fused_psteps_fwd_smem_bytes(
                    k, 3, c, P.EDGE_RATIO * c, blocks, int(staged))
                if got != want:
                    raise RuntimeError(
                        f"fused_psteps_fwd.{tag}: the library takes {got} B "
                        f"at {c} nodes, K {k}; fwd_smem_floats {want}")
            out.append(f"{tag or 'narrow'} K {k} {cap} nodes a block, "
                       f"{want} B (grid of {most}; tables "
                       f"{'staged' if staged else 'in device memory'})")
    return ", ".join(out)


@contextlib.contextmanager
def _forced_bwd_shape(mod, route, grid, spilled):
    """Force a reverse walk's route (`mod.device_bwd_shape`, the rule's
    shape with its route replaced) for the launches inside: None (the
    rule's own choice), 'cluster C' (one cluster of C blocks), 'grid'
    (`grid` blocks, by default one per mod.GRID_NODES of the n slots, at
    least 2, at most 128), 'grid G' (G blocks), 'spilled' (a block per 128
    slots, at least 2, with 16-node tiles: `spilled(shape, tag, *rest)`
    sizes them)."""
    kind, _, arg = (route or "").partition(" ")
    if route is not None and not (
            (kind == "cluster" and arg in ("1", "2", "4", "8"))
            or (kind == "grid" and (not arg or arg.isdigit()))
            or route == "spilled"):
        raise ValueError(f"unknown route {route!r}")
    if kind == "grid" and arg:
        route, grid = "grid", int(arg)
    keep = mod.device_bwd_shape

    def forced(n, tag, *rest):
        s = keep(n, tag, *rest)
        if route is None:
            return s
        if route.startswith("cluster"):
            return s._replace(route="cluster", grid=int(route.split()[1]))
        per = 128 if route == "spilled" else mod.GRID_NODES
        s = s._replace(route="grid",
                       grid=grid or min(128, max(2, -(-n // per))))
        return spilled(s, tag, *rest) if route == "spilled" else s
    mod.device_bwd_shape = forced
    try:
        yield
    finally:
        mod.device_bwd_shape = keep


def _bwd_route(route, grid=None):
    """Force fused_step_bwd's route for the launches inside (kernels/
    fused_step.py::launch_shape; _forced_bwd_shape). The GPU tests, the
    emulator's checks and scripts/time_fused_step.py --sweep force routes
    through it."""
    from mpnn_tpu_torch.kernels import fused_step as K
    return _forced_bwd_shape(K, route, grid, lambda s, tag, k, steps, *_: (
        s._replace(ncap=16, ecap=16 * K.EDGE_RATIO,
                   smem_bytes=4 * K.bwd_smem_floats(
                       tag, k, steps, 16, 16 * K.EDGE_RATIO))))


def _att_bwd_route(route, grid=None):
    """Force fused_att_steps_bwd's route (kernels/fused_att_steps.py::
    launch_shape) for the launches inside, as _bwd_route forces
    fused_step_bwd's."""
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    return _forced_bwd_shape(AS, route, grid, lambda s, tag, tm, k, steps,
                             *_: s._replace(
        ncap=16, ecap=16 * AS.EDGE_RATIO,
        smem_bytes=4 * AS.bwd_smem_floats(tag, tm, k, steps, 16,
                                          16 * AS.EDGE_RATIO)))


@contextlib.contextmanager
def _eval_route(route):
    """Force the folded serving kernel's route (kernels/fused_step.py::
    eval_launch_shape) for the launches inside: None (the rule's own
    choice), 'nodes P' (a block per P slots), 'one' (a single block),
    'spilled' (the rule's blocks, every tile in global scratch)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    kind, _, p = (route or "").partition(" ")
    if route is not None and route not in ("one", "spilled") and (
            kind != "nodes" or not p.isdigit() or int(p) < 1):
        raise ValueError(f"fused_eval: unknown route {route!r}")
    keep = K.device_eval_shape

    def forced(n, tag, k_vocab, steps, device, graphs=0):
        s = keep(n, tag, k_vocab, steps, device, graphs)
        if route is None:
            return s
        if route == "spilled":
            return s._replace(ncap=1, ecap=K.EDGE_RATIO,
                              smem_bytes=4 * K.eval_smem_floats(
                                  tag, k_vocab, steps, 1))
        smem = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
        return K.eval_launch_shape(
            n, tag, k_vocab, steps, smem_bytes=smem, max_grid=s.grid,
            graphs=graphs, nodes=1 << 30 if route == "one" else int(p))
    K.device_eval_shape = forced
    try:
        yield
    finally:
        K.device_eval_shape = keep


@contextlib.contextmanager
def _adv_bwd_route(route):
    """Force the adv model's backward launch (kernels/fused_att.py::
    launch_shape) for the launches inside: None (the rule's own choice),
    'nodes P' (a block per P slots), 'one' (a single block), 'spilled'
    (the rule's blocks, every tile in global scratch), as _eval_route
    forces the folded serving kernel's."""
    import torch
    from mpnn_tpu_torch.kernels import fused_att as A
    kind, _, p = (route or "").partition(" ")
    if route is not None and route not in ("one", "spilled") and (
            kind != "nodes" or not p.isdigit() or int(p) < 1):
        raise ValueError(f"fused_att_bwd: unknown route {route!r}")
    keep = A.device_bwd_shape

    def forced(n, tag, k_vocab, graphs, device):
        s = keep(n, tag, k_vocab, graphs, device)
        if route is None:
            return s
        if route == "spilled":
            return s._replace(ncap=1, ecap=A.EDGE_RATIO,
                              smem_bytes=4 * A.bwd_smem_floats(tag, k_vocab,
                                                               1))
        smem = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
        return A.launch_shape(n, tag, k_vocab, smem_bytes=smem,
                              max_grid=s.grid, graphs=graphs,
                              nodes=1 << 30 if route == "one" else int(p))
    A.device_bwd_shape = forced
    try:
        yield
    finally:
        A.device_bwd_shape = keep


# the adv backward's forced routes (_adv_bwd_route; None is the rule's)
ADV_BWD_ROUTES = (None, "nodes 1", "nodes 64", "one", "spilled")


@contextlib.contextmanager
def _forced_fwd_shape(mod, route, grid):
    """Force a forward kernel's route (`mod.device_fwd_shape`, the rule's
    shape with its route replaced; the tile from `mod.fwd_capacity` and
    `mod.fwd_smem_floats`) for the launches inside: None (the rule's own
    choice), 'cluster C', 'grid' (`grid` blocks, by default one per
    FWD_GRID_NODES of the n slots, at least 2, at most 128), 'spilled' (a
    block per 128 slots, at least 2, with 16-node tiles: blocks keep their
    graphs in global scratch)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    keep = mod.device_fwd_shape

    def forced(n, tag, k, steps, sums, device, *rest):
        s = keep(n, tag, k, steps, sums, device, *rest)
        if route is None:
            return s
        if route.startswith("cluster"):
            s = s._replace(route="cluster", grid=int(route.split()[1]))
        else:
            per = 128 if route == "spilled" else K.FWD_GRID_NODES
            s = s._replace(route="grid",
                           grid=grid or min(128, max(2, -(-n // per))))
        smem = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
        cap = (16 if route == "spilled" else
               min(s.ncap, mod.fwd_capacity(tag, k, steps, smem, s.grid)))
        return s._replace(ncap=cap, ecap=cap * mod.EDGE_RATIO,
                          smem_bytes=4 * mod.fwd_smem_floats(
                              tag, k, steps, cap, cap * mod.EDGE_RATIO,
                              s.grid))
    mod.device_fwd_shape = forced
    try:
        yield
    finally:
        mod.device_fwd_shape = keep


def _fwd_route(route, grid=None):
    """Force the shared family's forward kernels' route (fused_step_fwd and
    the stateless serving kernel: kernels/fused_step.py::fwd_launch_shape)
    for the launches inside (_forced_fwd_shape), as _bwd_route forces the
    backward's."""
    from mpnn_tpu_torch.kernels import fused_step as K
    return _forced_fwd_shape(K, route, grid)


def _ps_fwd_route(route, grid=None):
    """Force fused_psteps_fwd's route (kernels/fused_psteps.py::
    fwd_launch_shape) for the launches inside (_forced_fwd_shape)."""
    from mpnn_tpu_torch.kernels import fused_psteps as P
    return _forced_fwd_shape(P, route, grid)


def _route_matches(shape, route):
    """Whether a launch's shape is the forced `route`'s (None: any)."""
    if route is None:
        return True
    if shape.route != {"spilled": "grid"}.get(route, route.split()[0]):
        return False
    return (not route.startswith("cluster")
            or shape.grid == int(route.split()[1]))


def _bwd_route_checks(what, eval_args, od, steps, mn, sn, routes, gen,
                      device):
    """fused_step_bwd on each forced route against autograd through the
    plain version (each leaf divided by its max abs; rtol 1e-4, atol
    1e-5), run twice for the same bits, one forward and one backward
    launch a run. Returns (report, worst error, failed)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    sargs, leaves = _shell_step_args(eval_args, gen)
    h0 = sargs[3]
    n, f = h0.shape
    k = sargs[0].shape[0]
    tag = K.width_bucket("", K.BUCKETS, f=f, od=od)
    cw = torch.randn(sargs[10].shape[0], od, generator=gen).to(device)
    kw = dict(steps=steps, msg_norm=mn, state_norm=sn)
    want = _step_and_grads(K.fused_step_reference, sargs, leaves, cw, kw)
    out, worst, failed = [], 0.0, []
    for route in routes:
        with _bwd_route(route):
            K.reset_launch_counts()
            got = _step_and_grads(K.fused_step, sargs, leaves, cw, kw)
            again = _step_and_grads(K.fused_step, sargs, leaves, cw, kw)
            torch.cuda.synchronize()
            shape = K.device_bwd_shape(n, tag, k, steps, sn != "none",
                                       device)
        counts = (K.launch_counts["fused_step_fwd"],
                  K.launch_counts["fused_step_bwd"])
        same = all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
        _, _, ok_b, err_b = _step_errors(got, want, mn)
        ok = (ok_b and same and counts == (2, 2)
              and _route_matches(shape, route))
        worst = max(worst, err_b)
        out.append(f"{shape.tag()} {err_b:.2e}"
                   + ("" if same else " BITS DIFFER")
                   + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"{what} {route}")
    return (f"{what} {mn}/{sn} f={f} od={od} T={steps} K={k} "
            f"({n} slots): " + ", ".join(out)), worst, failed


def _step_float64(sargs, leaves, cw, kw):
    """_step_and_grads through fused_step_reference in float64 on the same
    batch (tests/test_torch_gpu.py::float64_step_and_grads)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K

    def dbl(x):
        if isinstance(x, dict):
            return {key: dbl(v) for key, v in x.items()}
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.detach().double()
        return x
    a64 = [dbl(a) for a in sargs]
    amat, a0, mbias, h0, _, _, gru, ma, bn, ro = a64[:10]
    l64 = [amat, a0, mbias, h0, *gru.values(), *ma.values(), *bn.values(),
           ro["i"]["w"], ro["i"]["b"], ro["j"]["w"], ro["j"]["b"]]
    for x in l64:
        x.requires_grad_()
    return _step_and_grads(K.fused_step_reference, a64, l64, cw.double(), kw)


def _exact_grad_errors(got, want, exact, msg_norm):
    """Each gradient leaf's distance from the float64 answer, scaled by
    its max abs, for the kernel and the plain float32 version: (ok: the
    kernel within ATOL of it or no further than the plain version, worst
    kernel distance, worst plain distance); message_bias under the
    message bn1d (zero in theory) left out."""
    ok, dk_max, dp_max = True, 0.0, 0.0
    for i, (k, p, x) in enumerate(zip(got[1], want[1], exact[1])):
        if i == 2 and msg_norm == "bn1d":
            continue
        scale = float(x.abs().max()) or 1.0
        dk = float((k.double() - x).abs().max()) / scale
        dp = float((p.double() - x).abs().max()) / scale
        ok = ok and dk <= max(ATOL, dp)
        dk_max, dp_max = max(dk_max, dk), max(dp_max, dp)
    return ok, dk_max, dp_max


def _fwd_route_checks(what, eval_args, od, steps, mn, sn, routes, gen,
                      device):
    """The forward kernels on each forced route (_fwd_route): the training
    forward's loss, out, stats and stash (htil, padded slots zero) against
    the plain version's, and with the stateless state norm the serving
    kernel against fused_eval_reference (rtol 1e-4, atol 1e-5); the
    backward on each route's stash against a float64 run of the plain
    version (each leaf within 1e-5 of its max abs, or no further than the
    plain float32 version, whose batch sums PyTorch runs with atomics:
    its gradients sat 1.1-1.4e-5 from the kernel's at b1024 bn1d/bn1d);
    each twice for the same bits, with exact launch counts. Returns
    (report, worst forward error, worst backward distance from float64,
    worst serving error, failed)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    sargs, leaves = _shell_step_args(eval_args, gen)
    (amat, a0, mbias, h0, mask, ng, gru, ma, bn, ro, labels, gmask, vid,
     src, dst, plan) = sargs
    n, f = h0.shape
    k = amat.shape[0]
    n_real = int(mask.sum())
    tag = K.width_bucket("", K.BUCKETS, f=f, od=od)
    cw = torch.randn(labels.shape[0], od, generator=gen).to(device)
    kw = dict(steps=steps, msg_norm=mn, state_norm=sn)
    meta = K.StepMeta(steps, K.BATCH_BN if mn == "bn1d" else K.NONE,
                      K._STATE_MODE[sn])
    det = lambda d: {key: (det(v) if isinstance(v, dict) else v.detach())
                     for key, v in d.items()}
    weights = K._flat_weights(amat.detach(), a0.detach(), mbias.detach(),
                              det(gru), det(ma), det(bn), det(ro))
    res_args = (weights, h0.detach(), mask, ng, labels, gmask, vid, src, dst,
                plan, meta)
    ref = K._reference_residuals(*res_args)
    want = _step_and_grads(K.fused_step_reference, sargs, leaves, cw, kw)
    exact = _step_float64(sargs, leaves, cw, kw)
    stateless = sn == "stateless"
    if stateless:
        with torch.no_grad():
            served_want = K.fused_eval_reference(*eval_args, **kw)
    out, failed = [], []
    worst = {"fwd": 0.0, "bwd": 0.0, "eval": 0.0}
    for route in routes:
        K.reset_launch_counts()
        with _fwd_route(route):
            got = _step_and_grads(K.fused_step, sargs, leaves, cw, kw)
            again = _step_and_grads(K.fused_step, sargs, leaves, cw, kw)
            stash = K.forward_residuals(*res_args)
            served = served2 = None
            if stateless:
                with torch.no_grad():
                    served = K.fused_eval(*eval_args, **kw)
                    served2 = K.fused_eval(*eval_args, **kw)
            torch.cuda.synchronize()
            shape = K.device_fwd_shape(n, tag, k, steps,
                                       mn != "none" or sn != "none", device)
        counts = {key: v for key, v in K.launch_counts.items() if v}
        want_counts = {"fused_step_fwd": 3, "fused_step_bwd": 2}
        if stateless:
            want_counts["fused_eval_stateless"] = 2
        ok_f, err_f, _, _ = _step_errors(got, want, mn)
        ok_b, err_b, err_p = _exact_grad_errors(got, want, exact, mn)
        for a, b in zip(stash, ref):
            ok, mabs, _ = _within(a, b)
            ok_f, err_f = ok_f and ok, max(err_f, mabs)
        pad = float(stash[3][:, n_real:].abs().max()) if n > n_real else 0.0
        same = (all(torch.equal(a, b) for a, b in zip(got[0], again[0]))
                and all(torch.equal(a, b) for a, b in zip(got[1], again[1])))
        err_e, ok_e = 0.0, True
        if stateless:
            ok_e, err_e, _ = _within(served, served_want)
            same = same and torch.equal(served, served2)
        ok = (ok_f and ok_b and ok_e and same and pad == 0.0
              and counts == want_counts and _route_matches(shape, route))
        worst["fwd"] = max(worst["fwd"], err_f)
        worst["bwd"] = max(worst["bwd"], err_b)
        worst["eval"] = max(worst["eval"], err_e)
        out.append(f"{shape.tag()} fwd {err_f:.2e} bwd {err_b:.2e} from "
                   f"float64 (plain {err_p:.2e})"
                   + (f" serve {err_e:.2e}" if stateless else "")
                   + ("" if same else " BITS DIFFER")
                   + ("" if pad == 0.0 else f" PAD {pad:.1e}")
                   + ("" if counts == want_counts else f" LAUNCHES {counts}")
                   + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"{what} {route}")
    return (f"{what} {mn}/{sn} f={f} od={od} T={steps} K={k} "
            f"({n_real}/{n} slots): " + ", ".join(out)), worst, failed


FWD_ROUTES = ("cluster 1", "cluster 2", "cluster 4", "cluster 8", "grid",
              "spilled")
# the folded serving kernel's routes (_eval_route; None the rule's)
EVAL_ROUTES = (None, "nodes 1", "nodes 64", "one", "spilled")
# fused_att_steps_bwd's routes (_att_bwd_route; None the rule's)
ATTS_BWD_ROUTES = (None, "cluster 1", "cluster 2", "cluster 4", "cluster 8",
                   "grid", "spilled")


CHECK_BATCH = 1024                   # kernel-check's large batch
TRAIN_TIMES_BATCHES = (16, 1024)     # train-times' batches


def phase_kernel_check(device):
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(1)
    flag = batch_to_device(_batch((SMILES * 103)[:CHECK_BATCH],
                                  CHECK_BATCH), device)
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
    # the folded kernel on every route: the rule's, a block a node, 64
    # nodes a block, one block, every tile spilled; b1024 and b16, the four
    # folded modes, each twice for the same bits
    b16 = batch_to_device(_batch((SMILES * 2)[:16], 16), device)
    lines = []
    for what, tb in (("b1024", flag), ("b16", b16), ("ragged", ragged)):
        k = int(tb["edge_vfirst"].shape[0])
        f = tb["node_feats"].shape[1] + tb["node_nafm"].shape[1]
        args = _kernel_args(tb, _random_weights(f, 14, k, gen, device))
        n = args[3].shape[0]
        errs = []
        for route in EVAL_ROUTES:
            with _eval_route(route):
                shape = K.device_eval_shape(
                    n, "", k, 6, device,
                    args[15].graph_node_ptr.shape[0] - 1)
            for mn in ("bn1d", "none"):
                for sn in ("bn1d", "none"):
                    kw = dict(steps=6, msg_norm=mn, state_norm=sn)
                    K.reset_launch_counts()
                    with _eval_route(route):
                        got = K.fused_eval(*args, **kw)
                        again = K.fused_eval(*args, **kw)
                    torch.cuda.synchronize()
                    want = K.fused_eval_reference(*args, **kw)
                    ok, mabs, _ = _within(got, want)
                    ok = (ok and torch.equal(got, again)
                          and K.launch_counts["fused_eval"] == 2)
                    worst = max(worst, mabs)
                    errs.append(mabs)
                    if not ok:
                        failed.append(f"{what} {route} {mn}/{sn}")
            lines.append(f"{what} {route or 'rule'} ({shape.tag()}) max_abs "
                         f"{max(errs[-4:]):.3e}")
    print(f"kernel-check: fused_eval's routes vs fused_eval_reference "
          f"(rtol {RTOL}, atol {ATOL}; the four folded modes, two runs, the "
          f"same bits; one launch each): " + "; ".join(lines), flush=True)
    if failed:
        raise RuntimeError(f"fused_eval disagrees on a route: {failed}")
    worst_fwd, worst_bwd, worst_sl, results = 0.0, 0.0, 0.0, []
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
    # the backward on every route of its rule: one block, clusters of 2, 4
    # and 8, the grid, the grid with tiles too small for the graphs
    lines = []
    every = ("cluster 1", "cluster 2", "cluster 4", "cluster 8", "grid",
             "spilled")
    for what, tb, mn, sn, routes in (
            ("b1024", flag, "bn1d", "bn1d", every),
            ("b1024", flag, "none", "none", ("cluster 8", "grid")),
            ("b16", b16, "bn1d", "bn1d", every),
            ("b16", b16, "bn1d", "none", ("cluster 1", "grid")),
            ("ragged", ragged, "bn1d", "bn1d", ("cluster 1", "grid",
                                                "spilled"))):
        k = int(tb["edge_vfirst"].shape[0])
        f = tb["node_feats"].shape[1] + tb["node_nafm"].shape[1]
        w = _random_weights(f, 14, k, gen, device)
        line, err, bad = _bwd_route_checks(
            what, _shell_args(tb, w, True, gen), 14, 6, mn, sn, routes, gen,
            device)
        lines.append(line)
        worst_bwd = max(worst_bwd, err)
        failed += bad
    print(f"kernel-check: fused_step_bwd's routes vs autograd through "
          f"fused_step_reference (each leaf divided by its max abs, rtol "
          f"{RTOL} atol {ATOL}; two runs, the same bits; one launch each; "
          f"h0 random at the padded slots): " + "; ".join(lines),
          flush=True)
    if failed:
        raise RuntimeError(f"fused_step_bwd disagrees on a route: {failed}")
    # the forward kernels on every route of their rule: one block, clusters
    # of 2, 4 and 8, the grid, the grid with tiles too small for the graphs
    lines = []
    for what, tb, mn, sn, routes in (
            ("b1024", flag, "bn1d", "bn1d", FWD_ROUTES),
            ("b1024", flag, "none", "none", ("cluster 8", "grid")),
            ("b1024", flag, "bn1d", "stateless", ("cluster 8", "grid",
                                                  "spilled")),
            ("b16", b16, "bn1d", "bn1d", FWD_ROUTES),
            ("b16", b16, "none", "stateless", FWD_ROUTES),
            ("ragged", ragged, "bn1d", "bn1d", ("cluster 1", "grid",
                                                "spilled"))):
        k = int(tb["edge_vfirst"].shape[0])
        f = tb["node_feats"].shape[1] + tb["node_nafm"].shape[1]
        w = _random_weights(f, 14, k, gen, device)
        line, errs, bad = _fwd_route_checks(
            what, _shell_args(tb, w, True, gen), 14, 6, mn, sn, routes, gen,
            device)
        lines.append(line)
        worst_fwd = max(worst_fwd, errs["fwd"])
        worst_bwd = max(worst_bwd, errs["bwd"])
        worst_sl = max(worst_sl, errs["eval"])
        failed += bad
    print(f"kernel-check: the forward kernels' routes (fused_step_fwd's "
          f"loss, out, stats and stash vs the plain version's, "
          f"fused_eval_stateless vs fused_eval_reference, rtol {RTOL} atol "
          f"{ATOL}; the backward on that stash vs a float64 run of the "
          f"plain version, each leaf within {ATOL} of its max abs or no "
          f"further than the plain float32 version; two runs, the same "
          f"bits; padded stash slots zero; exact launches): "
          + "; ".join(lines), flush=True)
    if failed:
        raise RuntimeError(f"the forward kernels disagree on a route: "
                           f"{failed}")
    return {"fused_eval": worst, "fused_step_fwd": worst_fwd,
            "fused_step_bwd": worst_bwd, "fused_eval_stateless": worst_sl}


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
        _mlp_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", "lipo", "--data", csv,
                      "--ckpt", ckpt, "--batch-size", str(bs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts["fused_eval"]
        mlp = _mlp_take(f"predict at batch {bs}", _nets(net.cfg.mpnn),
                        launches, 0)
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
                     f"{launches} kernel launches, edge-MLP {mlp}, "
                     f"{wall:.2f} s wall "
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


def _bound_ms(b, f, od, k, steps, stateless=False):
    """Least time of the eval kernel's work on this batch: the larger of
    its float32 operations over the peak CUDA-core rate and its bytes
    (each input read once, the output written once) over HBM bandwidth.
    Counts real nodes and edges only. The stateless state norm adds its
    two batch sums per step (Σx, Σ(x − mean)²)."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    ops = (nr * f + g * 2 * f * f                 # S_g and A0·S_g
           + er * 2 * f * f                        # per-edge A·h0 and sum
           + nr * 5 * f                            # + base + bias, affine
           + nr * (2 * f * 3 * f + 3 * f)          # input gates
           + steps * nr * (2 * f * 3 * f + 3 * f + 19 * f)   # GRU + norm
           + (steps * nr * 4 * f if stateless else 0)        # batch sums
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


def _trace(fn, cpu=True):
    """A torch.profiler trace of `fn()` (each run ended by a device sync)
    that reads the second of two runs, the first the profiler's warm-up:
    the first kernels after the profiler starts can go missing from its
    trace (a single-run trace once lacked a train step's first chain
    kernel, and once att's three edge-MLP forwards at the head of its
    step). `cpu` adds the host's ops to the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    return prof


def _trace_kernels(fn, kernels, cpu=True):
    """_trace of `fn()`, taken again (up to three traces) while one of the
    named kernels shows no device time in it (a trace can still lose the
    launches at its head, as the edge-MLP forwards of adv's b1024 step
    once were): (trace, device busy us, device ops, {kernel: device us});
    the caller fails on a kernel that stays at zero."""
    for _ in range(3):
        prof = _trace(fn, cpu)
        busy, ops = _device_ops(prof)
        kern = {k: sum(getattr(e, "self_device_time_total", 0.0)
                       for e in ops if f"{k}_kernel" in e.key)
                for k in kernels}
        if min(kern.values()) > 0:
            break
    return prof, busy, ops, kern


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


def _mm_count(prof):
    """Host-side aten::mm calls in a trace: with the edge-MLP chain in its
    kernels, none is left from the ×50 tails."""
    return sum(e.count for e in prof.key_averages() if e.key == "aten::mm")


def phase_profile(device, runs, request_ms):
    """Device-time breakdown of one batch-1024 request: busy time = the
    union of the request's device kernels and copies (_device_ops); the
    idle share compares it with the unprofiled request median. Fails when
    the trace shows no device time for the kernel."""
    import torch
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch)
    net, loader = runs[1024]
    b = next(iter(loader))
    step = eval_step_for_batch(net.cfg, "mse", b)
    step(net, batch_to_device(b, device))
    torch.cuda.synchronize()
    prof = _trace(lambda: step(net, batch_to_device(b, device))[1].cpu())
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
          f"{sum(e.count for e in ops)} device ops (kernels and copies), "
          f"{_mm_count(prof)} aten::mm; "
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
    _mlp_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--experiment", "lipo", "--data", csv,
                  "--epochs", str(TRAIN_EPOCHS), "--batch-size",
                  str(TRAIN_BATCH), "--ckpt-dir", ckdir, "--log", log])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    counts.update(_mlp_take(
        "train", 1, counts["fused_step_fwd"] + counts["fused_eval"],
        counts["fused_step_bwd"]))
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


def _step_bounds(b, f, od, k, steps, msg_norm="bn1d", state_norm="bn1d"):
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
    products. A norm in mode 'none' takes no operations; bn1d and the
    stateless norm the same count (the batch sums, the normalization)."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    weights = k * f * f + f * f + 6 * f * f + 11 * f + 4 * f * od + 2 * od
    gemv = 2 * f * 3 * f                           # one f → 3f gate GEMV
    gate = 3 * f + 12 * f                          # + b_hh, the gate math
    norm = 8 * f if state_norm != "none" else 0    # stats + normalize
    mnorm = 8 * f if msg_norm != "none" else 0
    ro_gemv = 2 * 2 * (2 * f) * od                 # W_i·x and W_j·x
    fwd_ops = (er * 2 * f * f + g * 2 * f * f + nr * 3 * f  # messages
               + nr * mnorm + nr * (gemv + 3 * f)           # ma BN, gi once
               + steps * nr * (gemv + gate + norm)
               + nr * (ro_gemv + 8 * od) + g * 3 * od)      # readout, loss
    stash = (steps + 1) * nr * f + 2 * (steps + 1) * f
    fwd_bytes = 4 * (nr * f + er * 3 + nr + g * 2 + weights + 1 + g * od
                     + stash)
    bwd_ops = (nr * (3 * ro_gemv + 16 * od)                  # readout VJP
               + steps * nr * (3 * gemv + gate + 20 * f + 2 * norm)
               + nr * 2 * gemv                               # W_ih, Σ dgi
               + nr * 2 * mnorm                              # message BN
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


def _kernel_trace_us_n(n, *prepared):
    """Device time of n launches of each prepared kernel, in turns, from
    one torch.profiler trace (us, summed over the n). A trace that holds
    none of a kernel's launches (a short trace can lose them) is taken
    again, up to three times."""
    for _ in range(3):
        got = list(_kernel_trace_us(*(list(prepared) * n)).values())
        if all(v > 0 for v in got):
            break
    return got


def _kernel_trace_us(*prepared):
    """Device time of one launch of each prepared training kernel, from a
    torch.profiler trace (the events' time over back-to-back launches also
    holds any host launch gap)."""
    from mpnn_tpu_torch.kernels import fused_step as K
    prof = _trace(lambda: [K.launch_prepared(p) for p in prepared],
                  cpu=False)
    _, ops = _device_ops(prof)
    return {p.name: sum(getattr(e, "self_device_time_total", 0.0)
                        for e in ops if f"{p.name}_kernel" in e.key)
            for p in prepared}


def _bwd_phases(p, T):
    """fused_step_bwd's clock64 stamps (block 0, thread 0; cycles) as
    phases: staging and the vocab sort, the readout VJP, its batch sums'
    combine, one walk step's arithmetic and its combine (mean over the T
    steps), W_hh's and W_ih's rows (W_ih's products once), the message
    norm's combine, the message VJP, dA, the final sum."""
    steps = [(p[4 + 2 * i] - p[3 + 2 * i], p[5 + 2 * i] - p[4 + 2 * i])
             for i in range(T)]
    return {"staging": p[1] - p[0], "readout": p[2] - p[1],
            "readout combine": p[3] - p[2],
            "step": sum(a for a, _ in steps) / T,
            "step combine": sum(b for _, b in steps) / T,
            "W_hh rows": p[70] - p[3 + 2 * T], "W_ih once": p[71] - p[70],
            "message combine": p[72] - p[71], "message VJP": p[73] - p[72],
            "dA": p[74] - p[73], "final sum": p[75] - p[74],
            "total": p[75] - p[0]}


def _bwd_detail(weights, h0, labels, gmask, o, gout, gl, htil, st, ng, vid,
                src, dst, plan, meta, device, tag=None):
    """fused_step_bwd's route on these inputs, the empty-walk floor
    (CUDA events over 100 launches of the same grid and combines with no
    arithmetic) and block 0's clock64 phases of one launch."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    args = (weights, h0, labels, gmask, o, gout, gl, htil, st, ng, vid, src,
            dst, plan, meta)
    pfl = K.prepare_fused_step_bwd(*args, tag=tag, floor=True)
    floor_ms = _events_ms(lambda: K.launch_prepared(pfl), 100)
    prof = torch.zeros(K.PROF_SLOTS, dtype=torch.int64, device=device)
    counts = dict(K.launch_counts)
    K.launch_prepared(K.prepare_fused_step_bwd(*args, tag=tag, prof=prof))
    K.launch_counts.update(counts)
    torch.cuda.synchronize()
    tag = K.bucket_of("fused_step", tag, f=h0.shape[1], od=o.shape[1])
    shape = K.device_bwd_shape(h0.shape[0], tag, weights[0][1].shape[0],
                               meta.steps, meta.state_mode != K.NONE, device)
    phases = _bwd_phases(prof.tolist(), meta.steps)
    return shape.tag(), floor_ms, phases


def _fwd_phases(p, T):
    """The forward kernels' clock64 stamps (block 0, thread 0; cycles) as
    phases: the weights, the block's partition and its tile staged, the
    messages (A0 term and the edges), the message norm's combine, one
    step's node pass and its combine (mean over the T steps), the
    readout's gated rows, the per-graph sums, the route's finish (the
    loss); with a state norm on statistics also step 1's combine in four
    parts."""
    steps = [(p[4 + 2 * i] - p[3 + 2 * i], p[5 + 2 * i] - p[4 + 2 * i])
             for i in range(T)]
    out = {"staging": p[1] - p[0], "messages": p[2] - p[1],
           "message combine": p[3] - p[2],
           "step": sum(a for a, _ in steps) / T,
           "step combine": sum(b for _, b in steps) / T,
           "readout rows": p[70] - p[3 + 2 * T],
           "graph sums": p[71] - p[70], "finish": p[75] - p[71],
           "total": p[75] - p[0]}
    if p[79]:
        # step 1's combine across blocks: the block's partial row, the
        # wait for every block's, the rows staged, the two sums
        out.update({"s1 block partial": p[76] - p[4],
                    "s1 wait": p[77] - p[76], "s1 staged": p[78] - p[77],
                    "s1 sums": p[79] - p[78]})
    return out


def _fwd_detail(prepare, n, tag, k, steps, sums, device, kernel):
    """A forward kernel's route on these inputs (`prepare(**kw)` makes its
    launch), the empty-forward floor (CUDA events over 100 launches of the
    same grid and combines with no arithmetic) and block 0's clock64
    phases of one launch."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    pfl = prepare(floor=True)
    floor_ms = _events_ms(lambda: K.launch_prepared(pfl), 100)
    prof = torch.zeros(K.FWD_PROF_SLOTS, dtype=torch.int64, device=device)
    counts = dict(K.launch_counts)
    K.launch_prepared(prepare(prof=prof))
    K.launch_counts.update(counts)
    torch.cuda.synchronize()
    shape = K.device_fwd_shape(n, tag, k, steps, sums, device, kernel)
    return shape.tag(), floor_ms, _fwd_phases(prof.tolist(), steps)


def _walk_phases(p, T, names):
    """A reverse walk's clock64 stamps (block 0, thread 0; cycles) as
    phases: `names` maps the stamps before the walk (0..3) and after it
    (70..75) to their phases; the walk's steps are stamps 3 + 2i (its
    start) to 4 + 2i (its arithmetic) to 5 + 2i (its combine), averaged
    over the T steps (the combine over the steps that have one)."""
    arith = [p[4 + 2 * i] - p[3 + 2 * i] for i in range(T)]
    comb = [p[5 + 2 * i] - p[4 + 2 * i] for i in range(T - 1)]
    out = {"step": sum(arith) / T,
           "step combine": sum(comb) / max(len(comb), 1)}
    for name, (a, b) in names.items():
        out[name] = p[b] - p[a]
    out["total"] = p[75] - p[0]
    return out


def _rec_bwd_phases(p, T):
    """recurrence_bwd's clock64 phases: staging, the input gates and slot
    T's sums, their combine, one walk step's arithmetic and its combine,
    W_hh's rows, W_ih's products once with the message sums, their
    combine, ∂msgs, the final sum."""
    last = 4 + 2 * (T - 1)
    return _walk_phases(p, T, {
        "staging": (0, 1), "gates": (1, 2), "slot T combine": (2, 3),
        "W_hh rows": (last + 1, 70), "W_ih once": (70, 71),
        "message combine": (71, 72), "dmsgs": (72, 73),
        "final sum": (73, 75)})


def _ps_bwd_phases(p, T):
    """fused_psteps_bwd's clock64 phases: staging and the vocab sort, the
    readout VJP (block-local: a block owns whole graphs), step T−1's state
    sums and their combine, one walk step's arithmetic and its combine
    (steps T−2..0), the weight rows, the T message norms' one combine,
    ∂m_t, the message VJP (A0_t, mbias_t, the edges' A_tᵀ), dA_t, the
    final sum."""
    last = 4 + 2 * (T - 1)
    return _walk_phases(p, T, {
        "staging": (0, 1), "readout": (1, 2), "step T−1 combine": (2, 3),
        "weight rows": (last, 70), "message combine": (70, 71),
        "dm": (71, 72), "message VJP": (72, 73), "dA": (73, 74),
        "final sum": (74, 75)})


def _walk_detail(prepare, shape_of, phases_of, counts, device):
    """A reverse-walk kernel's route (`shape_of()`), the empty-walk floor
    (CUDA events over 100 launches of the same grid and combines with no
    arithmetic; `prepare(floor=True)`) and block 0's clock64 phases of one
    launch (`prepare(prof=...)`), leaving the main path's launch `counts`
    as they were."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    pfl = prepare(floor=True)
    floor_ms = _events_ms(lambda: K.launch_prepared(pfl), 100)
    prof = torch.zeros(80, dtype=torch.int64, device=device)
    keep = dict(counts)
    K.launch_prepared(prepare(prof=prof))
    counts.update(keep)
    torch.cuda.synchronize()
    return shape_of().tag(), floor_ms, phases_of(prof.tolist())


def _detail_text(name, tag, floor_ms, phases):
    return (f"{name} route {tag}, empty walk {floor_ms * 1e3:.2f} us, "
            f"block 0 (cycles): " + ", ".join(
                f"{k} {v:.0f}" for k, v in phases.items()))


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
    for bs in TRAIN_TIMES_BATCHES:
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
        route, floor_ms, phases = _bwd_detail(
            weights, h0, labels, gmask, o, gout, gl, htil, st, ng, vid, src,
            dst, plan, meta, device)
        f_route, f_floor_ms, f_phases = _fwd_detail(
            lambda **kw: K.prepare_fused_step_fwd(
                weights, h0, mask, ng, labels, gmask, vid, src, dst, plan,
                meta, **kw), h0.shape[0],
            K.bucket_of("fused_step", None, f=h0.shape[1], od=o.shape[1]),
            amat.shape[0], meta.steps, True, device, "fused_step_fwd")
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
        out[bs]["fused_step_bwd"].update(route=route, floor_ms=floor_ms,
                                         phases=phases)
        out[bs]["fused_step_fwd"].update(route=f_route, floor_ms=f_floor_ms,
                                         phases=f_phases)
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
                for name in ("fused_step_fwd", "fused_step_bwd"))
            + f"; fused_step_fwd route {f_route}, empty-forward floor "
            f"{f_floor_ms * 1e3:.2f} us (events), block 0's clock64 cycles "
            + json.dumps({k: round(v) for k, v in f_phases.items()})
            + f"; fused_step_bwd route {route}, empty-walk floor "
            f"{floor_ms * 1e3:.2f} us (events), block 0's clock64 cycles "
            + json.dumps({k: round(v) for k, v in phases.items()}))
    print(f"train-times [{card}]: " + "; ".join(lines), flush=True)
    return out


def phase_train_profile(device, step_ms):
    """Device-time breakdown of one batch-1024 train step (forward,
    backward, Adam, running statistics); fails when the trace shows no
    device time for either training kernel."""
    import torch
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    gen = torch.Generator().manual_seed(3)
    b = _batch((SMILES * 103)[:1024], 1024)
    b["labels"] = torch.randn(1024, generator=gen).numpy()
    net, opt = _train_net(b, gen, device)
    for _ in range(2):
        float(train_step(net, opt, batch_to_device(b, device)))
    torch.cuda.synchronize()
    prof, busy, ops, kern = _trace_kernels(
        lambda: float(train_step(net, opt, batch_to_device(b, device))),
        ("fused_step_fwd", "fused_step_bwd", *MLP_KERNELS))
    ka = prof.key_averages()
    with open(os.path.join(OUT_DIR, "profile_train_1024.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    if min(kern.values()) <= 0:
        raise RuntimeError(f"train-profile: no device time for {kern}")
    top = sorted(ops, key=dev, reverse=True)[:6]
    print(f"train-profile: batch-1024 train step (H2D + forward + backward"
          f" + Adam + EMAs + loss read-back): device busy {busy:.1f} us in "
          f"{sum(e.count for e in ops)} device ops, {_mm_count(prof)} "
          f"aten::mm; "
          + ", ".join(f"{k}_kernel {v:.1f} us" for k, v in kern.items())
          + "; device idle share "
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
# ps-kernel-check's large batches, ps-times' batches
PS_CHECK_BATCHES = (1024, 2560)
PS_TIMES_BATCHES = (128, 1024)


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


# fused_psteps_bwd's forced routes (_ps_route): every route of its rule,
# and 16-node tiles that leave a block's graphs in global scratch
PS_ROUTES = ("cluster 1", "cluster 2", "cluster 4", "cluster 8", "grid",
             "spilled")


def _ps_route(route, grid=None):
    """Force fused_psteps_bwd's route for the launches inside (kernels/
    fused_psteps.py::launch_shape; _forced_bwd_shape). The GPU tests, the
    emulator's checks and scripts/time_fused_psteps.py --sweep force
    routes through it."""
    from mpnn_tpu_torch.kernels import fused_psteps as P
    return _forced_bwd_shape(P, route, grid, lambda s, tag, k, steps, *_: (
        s._replace(ncap=16, ecap=16 * P.EDGE_RATIO,
                   smem_bytes=4 * P.bwd_smem_floats(
                       tag, k, steps, 16, 16 * P.EDGE_RATIO))))


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


def ps_stash(c, steps, msg_norm, state_norm):
    """The per-step training forward kernel's outputs (loss, out, stats
    (2T, 2, f), htil (2T, N, f)) through forward_residuals on a
    _ps_case-style dict, and the plain version's on the same inputs."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    det = lambda x: ({k: det(v) for k, v in x.items()}
                     if isinstance(x, dict) else [det(v) for v in x]
                     if isinstance(x, list) else x.detach())
    weights, meta = P.flat_weights(
        c["amat"].detach(), c["a0"].detach(), c["mbias"].detach(),
        det(c["gru"]), det(c["ma_bns"]), det(c["bns"]), det(c["ro"]),
        c["h0"].detach(), steps=steps, msg_norm=msg_norm,
        state_norm=state_norm)
    args = (weights, c["h0"].detach(), c["mask"], c["node_graph"],
            c["labels"], c["gmask"], c["vid"], c["src"], c["dst"], c["plan"],
            meta)
    with torch.no_grad():
        return P.forward_residuals(*args), P._reference_residuals(*args)


# fused_psteps_fwd's forced routes in ps-kernel-check: both routes of its
# rule for every norm pair, and 16-node tiles
PS_FWD_ROUTES = ("cluster 8", "grid")


def _ps_fwd_route_checks(device, gen):
    """fused_psteps_fwd on forced routes (_ps_fwd_route): every norm pair on
    a cluster of 8 and on the grid at b16, b1024 on 16-node tiles
    (spilled), the wide bucket at T 6 (f 27, od 108) on the grid and on a
    cluster, K 64 (the tables in device memory) and a graph of 700 nodes:
    loss, out, every slot's statistics and the whole stash against the
    plain version (rtol 1e-4, atol 1e-5), padded slots zero, twice for
    the same bits, one launch a run. Returns (report, worst error,
    failed)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    b1024, b16, _, _ = _dec_check_batches(device)
    cases = ([("b16", b16, 8, 16, 3, mn, sn, r, None)
              for mn, sn in PS_NORMS for r in PS_FWD_ROUTES]
             + [("b1024", b1024, 8, 16, 3, "bn1d", "bn1d", "spilled", None),
                ("b16 wide T6", b16, 27, 108, 6, "none", "stateless",
                 "grid", None),
                ("b16 wide T6", b16, 32, 128, 6, "bn1d", "bn1d",
                 "cluster 4", None),
                ("b1024 K64", b1024, 16, 32, 3, "bn1d", "stateless", None,
                 64)])
    out, worst, failed = [], 0.0, []
    for what, tb, f, od, steps, mn, sn, route, k in cases:
        c, _ = _ps_case(tb, f, od, gen, device, steps=steps)
        if k is not None:
            c["amat"] = (0.2 * torch.randn(steps, k, f, f, generator=gen)
                         ).to(device)
            c["amat"][:, 0] = 0.0
            c["vid"] = torch.where(
                tb["edge_mask"] > 0, torch.randint(
                    1, k, c["vid"].shape, generator=gen,
                    dtype=torch.int32).to(device),
                torch.zeros_like(c["vid"])).contiguous()
        P.reset_launch_counts()
        with _ps_fwd_route(route):
            got, want = ps_stash(c, steps, mn, sn)
            again, _ = ps_stash(c, steps, mn, sn)
            torch.cuda.synchronize()
            n = c["h0"].shape[0]
            shape = P.device_fwd_shape(
                n, K.width_bucket("", P.BUCKETS, f=f, od=od, steps=steps),
                c["amat"].shape[1], steps, mn != "none" or sn != "none",
                device)
        errs = [_within(a, b) for a, b in zip(got, want)]
        err = max(e[1] for e in errs)
        n_real = int(tb["node_mask"].sum())
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = (all(e[0] for e in errs) and same
              and not got[3][:, n_real:].any()
              and P.launch_counts["fused_psteps_fwd"] == 2
              and _route_matches(shape, route)
              and all(bool(torch.isfinite(x).all()) for x in got))
        worst = max(worst, err)
        out.append(f"{what} {mn}/{sn} f={f} T={steps} K="
                   f"{c['amat'].shape[1]} {shape.tag()} {err:.2e}"
                   + ("" if same else " BITS DIFFER")
                   + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"fwd {what} {mn}/{sn} {route}")
    return ("fused_psteps_fwd on forced routes (loss, out, stats, stash; "
            "twice for the same bits): " + ", ".join(out)), worst, failed


def _ps_bwd_route_checks(device, gen):
    """fused_psteps_bwd on every forced route of its rule (_ps_route), one
    of the six norm pairs each at b16 (256 slots), then b1024 on 16-node
    tiles (spilled) and the ragged batch at graph_norm's widths in one
    block: each against autograd through the plain version (leaves
    divided by their max abs; rtol 1e-4, atol 1e-5), twice for the same
    bits, one forward and one backward launch a run. Returns (report,
    worst error, failed)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.train.trainer import batch_to_device
    b1024, b16, _, ragged = _dec_check_batches(device)
    cases = ([("b16", b16, 8, 16, mn, sn, r)
              for (mn, sn), r in zip(PS_NORMS, PS_ROUTES)]
             + [("b1024", b1024, 8, 16, "bn1d", "bn1d", "spilled"),
                ("ragged graph_norm", ragged, None, None, "none",
                 "stateless", "cluster 1")])
    out, worst, failed = [], 0.0, []
    whole = functools.partial(P.fused_psteps, bwd="whole")
    for what, tb, f, od, mn, sn, route in cases:
        feats = f is None
        f = int(tb["node_feats"].shape[1]) if feats else f
        od = 4 * f if feats else od
        c, leaves = _ps_case(tb, f, od, gen, device, from_feats=feats)
        kw = dict(steps=3, msg_norm=mn, state_norm=sn)
        cw = torch.randn(c["labels"].shape[0], od, generator=gen).to(device)
        with _ps_route(route):
            P.reset_launch_counts()
            got = _step_and_grads(whole, _ps_step_args(c), leaves, cw, kw)
            again = _step_and_grads(whole, _ps_step_args(c), leaves, cw,
                                    kw)
            torch.cuda.synchronize()
            shape = P.device_bwd_shape(
                c["h0"].shape[0], K.width_bucket("", P.BUCKETS, f=f, od=od,
                                                 steps=3),
                c["amat"].shape[1], 3, sn != "none", device)
        counts = (P.launch_counts["fused_psteps_fwd"],
                  P.launch_counts["fused_psteps_bwd"])
        want = _step_and_grads(P.fused_psteps_reference, _ps_step_args(c),
                               leaves, cw, kw)
        same = all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
        _, _, ok_b, err_b = _step_errors(got, want, mn)
        ok = (ok_b and same and counts == (2, 2)
              and _route_matches(shape, route))
        worst = max(worst, err_b)
        out.append(f"{what} {mn}/{sn} f={f} {shape.tag()} {err_b:.2e}"
                   + ("" if same else " BITS DIFFER")
                   + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"{what} {mn}/{sn} {route}")
    return ("fused_psteps_bwd on forced routes (T 3, twice for the same "
            "bits): " + ", ".join(out)), worst, failed


def phase_ps_kernel_check(device):
    """The per-step kernels against their plain versions on the card; the
    backward also on every forced route of its rule."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(11)
    nb, nbig = PS_CHECK_BATCHES
    b1024 = batch_to_device(_batch((SMILES * 256)[:nb], nb), device)
    ragged_smiles = SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
    ragged = batch_to_device(_batch(ragged_smiles, len(ragged_smiles)),
                             device)
    big = batch_to_device(_batch((SMILES * 256)[:nbig], nbig), device)
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
        # the whole backward kernel, past 28,672 slots too (where the
        # op's rule would split: split-kernel-check holds that route)
        got = _step_and_grads(functools.partial(P.fused_psteps, bwd="whole"),
                              _ps_step_args(c), leaves, cw, kw)
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
    report, err_r, failed_r = _ps_bwd_route_checks(device, gen)
    worst["fused_psteps_bwd"] = max(worst["fused_psteps_bwd"], err_r)
    failed += failed_r
    freport, err_f, failed_f = _ps_fwd_route_checks(device, gen)
    worst["fused_psteps_fwd"] = max(worst["fused_psteps_fwd"], err_f)
    failed += failed_f
    report += "; " + freport
    print(f"ps-kernel-check: fused_psteps_eval vs fused_psteps_eval_"
          f"reference, fused_psteps_fwd vs fused_psteps_reference, "
          f"fused_psteps_bwd vs autograd through it (T 3, cotangents "
          f"1.3·loss + Σ out·c; rtol {RTOL} atol {ATOL}, gradient leaves "
          f"divided by their max abs; message biases under the message "
          f"bn1d within {ATOL}·max|dA0|): " + "; ".join(results)
          + "; " + report, flush=True)
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
            _mlp_reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["predict", "--experiment", exp, "--data", csv,
                          "--ckpt", ckpt, "--batch-size", str(bs)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = P.launch_counts["fused_psteps_eval"]
            _mlp_take(f"{exp} predict at batch {bs}", _nets(net.cfg.mpnn),
                      launches, 0)
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
        _mlp_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["train", "--experiment", exp_name, "--data", csv,
                      "--epochs", str(TRAIN_EPOCHS), "--ckpt-dir", ckdir,
                      "--log", log])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(P.launch_counts)
        _mlp_take(f"{exp_name} train",
                  _nets(zoo.build(exp.model, afm=8, bfm=6).mpnn),
                  counts["fused_psteps_fwd"] + counts["fused_psteps_eval"],
                  counts["fused_psteps_bwd"])
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


def _ps_fwd_detail(fargs, device):
    """fused_psteps_fwd's route on these inputs (prepare_fused_psteps_fwd's
    arguments), the empty-forward floor (CUDA events over 100 launches of
    the same grid and combines with no arithmetic) and block 0's clock64
    phases of one launch (_fwd_phases: the stamps follow row 2's),
    leaving the launch counts as they were."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    weights, h0, meta = fargs[0], fargs[1], fargs[-1]
    pfl = P.prepare_fused_psteps_fwd(*fargs, floor=True)
    floor_ms = _events_ms(lambda: K.launch_prepared(pfl), 100)
    prof = torch.zeros(P.FWD_PROF_SLOTS, dtype=torch.int64, device=device)
    counts = dict(P.launch_counts)
    K.launch_prepared(P.prepare_fused_psteps_fwd(*fargs, prof=prof))
    P.launch_counts.update(counts)
    torch.cuda.synchronize()
    w = dict(weights)
    tag = K.width_bucket("", P.BUCKETS, f=h0.shape[1],
                         od=w["ro_ib"].shape[0], steps=meta.steps)
    shape = P.device_fwd_shape(
        h0.shape[0], tag, w["amat"].shape[1], meta.steps,
        meta.msg_mode != P.NONE or meta.state_mode != P.NONE, device)
    return shape.tag(), floor_ms, _fwd_phases(prof.tolist(), meta.steps)


def _ps_fwd_detail_text(tag, floor_ms, phases):
    return (f"fused_psteps_fwd route {tag}, empty forward "
            f"{floor_ms * 1e3:.2f} us, block 0 (cycles): " + ", ".join(
                f"{k} {v:.0f}" for k, v in phases.items()))


def phase_ps_times(device, card):
    """The encoded model at batch 128 and 1024: request latency and
    train-step latency (host clock ending in a device sync), each
    per-step kernel's time (CUDA events over repeated launches on the
    main path's inputs) beside its bound and its plain version's time,
    and the device busy time of one batch-1024 train step."""
    import statistics
    import torch
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
    for bs in PS_TIMES_BATCHES:
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
        if bs == PS_TIMES_BATCHES[-1]:
            prof = _trace(lambda: float(train_step(net, opt, tb,
                                                   loss_kind="ce")))
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
        fargs = (weights, h0, mask, ng, labels, gmask, vid, src, dst, plan,
                 meta)
        pf = P.prepare_fused_psteps_fwd(*fargs)
        f_ms = _events_ms(lambda: K.launch_prepared(pf), 100)
        f_trace = _kernel_trace_us_n(20, pf)[0] / 20
        fdetail = _ps_fwd_detail_text(*_ps_fwd_detail(fargs, device))
        _, o, st, htil = K.launch_prepared(pf)
        gout = torch.randn(o.shape, generator=gen).to(device)
        gl = torch.ones(1, device=device)
        pb = P.prepare_fused_psteps_bwd(weights, h0, labels, gmask, o, gout,
                                        gl, htil, st, ng, vid, src, dst,
                                        plan, meta)
        b_ms = _events_ms(lambda: K.launch_prepared(pb), 100)
        b_trace = _kernel_trace_us_n(20, pb)[0] / 20
        bargs = (weights, h0, labels, gmask, o, gout, gl, htil, st, ng, vid,
                 src, dst, plan, meta)
        detail = _detail_text("fused_psteps_bwd", *_walk_detail(
            lambda **kw: P.prepare_fused_psteps_bwd(*bargs, **kw),
            lambda: P.device_bwd_shape(
                h0.shape[0], K.width_bucket("", P.BUCKETS, f=h0.shape[1],
                                            od=o.shape[1], steps=meta.steps),
                amat.shape[1], meta.steps, meta.state_mode != P.NONE,
                device),
            lambda pr: _ps_bwd_phases(pr, meta.steps), P.launch_counts,
            device))
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
               "fused_psteps_fwd": dict(ms=f_ms, plain_ms=pf_ms,
                                        trace_ms=f_trace / 1e3),
               "fused_psteps_bwd": dict(ms=b_ms, plain_ms=pb_ms,
                                        trace_ms=b_trace / 1e3)}
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
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in PS_KERNELS)
            + f"; fused_psteps_fwd {f_trace:.2f} us (trace); {fdetail}"
            + f"; fused_psteps_bwd {b_trace:.2f} us (trace); " + detail)
    print(f"ps-times [{card}]: " + "; ".join(lines), flush=True)
    return out


# ---------------------------------------------------------------------------
# the attention model adv (adv_classification): phases 14-17
# ---------------------------------------------------------------------------

ATT_KERNELS = ("fused_att_fwd", "fused_att_bwd", "set2vec_fwd", "set2vec_bwd")
ATTS_KERNELS = ("fused_att_steps_fwd", "fused_att_steps_bwd")
# the two attention models: their experiment and message kernels (both
# read out through the set2vec kernels)
ATT_MODELS = {"adv": ("adv_classification", ATT_KERNELS[:2]),
              "att": ("att_classification", ATTS_KERNELS)}


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


# set2vec's routes at a size that forces each (kernels/set2vec.py::
# launch_shape): the node counts of the chunked case pass a block's
# staging capacity at w 14 (~3,100 rows forward, ~1,450 backward) and 54
S2V_CHUNKED_SIZES = (40, 4000)       # graphs; three of them this large
# w 54 on 300 graphs, the graphs of one block (2-3 on 132 SMs) empty
S2V_EMPTY_BLOCK = (300, slice(11, 13))
# graphs of the batches whose blocks hold more graphs than shared memory
# fits beside their rows: at w 32 the backward's leaf sums move to global
# scratch (past ~40 graphs a block); at w 54 (adv's training batch at afm
# 27) the backward's slots too, at w 64 both kernels' (the spilled route)
S2V_MANY_GRAPHS = {"global-acc": 6000, "spilled-bwd": 2048,
                   "spilled": 10000}
S2V_STEPS = 100                      # the reference's set2vec depth
ATT_CHECK_BATCH = 1024               # att-kernel-check's large batch
ATT_TIMES_BATCHES = (16, 1024)       # att-times' batches


def _s2v_sizes_case(sizes, w, gen, device):
    """set2vec's arguments on graphs of the given node counts (0: an empty
    graph) and five padded slots: random masked x (N, w) and leaves drawn
    as the JAX init draws them, every leaf requiring grad; (args,
    leaves)."""
    import numpy as np
    import torch
    sizes = np.asarray(sizes, np.int64)
    g, n_real = len(sizes), int(sizes.sum())
    n = n_real + 5
    ng = np.full(n, g, np.int32)
    ng[:n_real] = np.repeat(np.arange(g), sizes)
    gnp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    mask = torch.as_tensor((np.arange(n) < n_real).astype(np.float32)[:, None]
                           ).to(device)
    b = (2 * w) ** -0.5

    def u(*shape, b):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * b).to(device)
    rp = {"lstm": {**{f"w_h{c}": u(2 * w, w, b=b) for c in "ifgo"},
                   **{f"b_h{c}": u(1, w, b=b) for c in "ifgo"}},
          "q_attn": {"w": u(w, w, b=w ** -0.5)},
          "e_attn": {"w": u(w, 1, b=w ** -0.5)}}
    x = (torch.randn(n, w, generator=gen).to(device) * mask).contiguous()
    leaves = [*rp["lstm"].values(), rp["q_attn"]["w"], rp["e_attn"]["w"],
              x]
    for t in leaves:
        t.requires_grad_()
    return (rp, x, mask, torch.as_tensor(ng).to(device),
            torch.as_tensor(gnp).to(device)), leaves


def _s2v_tags(args, w, device):
    """(forward tag, backward tag) of a batch: S2vShape.tag, the route and
    what gives way on it (chunked, global-acc, spilled)."""
    from mpnn_tpu_torch.kernels import set2vec as S
    n, g = args[1].shape[0], args[4].shape[0] - 1
    ptr = args[4].cpu().tolist()
    return tuple(S.device_shape(d, n, g, w, device).tag(ptr)
                 for d in ("fwd", "bwd"))


def _s2v_route(args, w, device):
    """'fwd <tag> grid G warps W cap C; bwd ...' of a batch."""
    from mpnn_tpu_torch.kernels import set2vec as S
    n, g = args[1].shape[0], args[4].shape[0] - 1
    tags = _s2v_tags(args, w, device)
    return "; ".join(
        f"{d} {tag} grid {sh.grid} warps {sh.warps} cap {sh.cap}"
        for d, tag in zip(("fwd", "bwd"), tags)
        for sh in [S.device_shape(d, n, g, w, device)])


def _s2v_route_cases(b16):
    """(name, graph sizes, w, steps, (forward tag, backward tag)) of each
    set2vec route: b16 of bench.py at w 14 (one block), 54 and 64 (the
    wide backward's leaf sums in global scratch); 24 graphs (one block,
    two graphs a warp); 40 graphs, three past a block's capacity
    (chunked), at w 14 and 54; 300 graphs at w 54, one block's graphs
    empty; S2V_MANY_GRAPHS' batches at w 32, 54 and 64."""
    import numpy as np
    rng = np.random.RandomState(12)
    ragged = lambda g: np.concatenate([[1, 1, 1], rng.randint(1, 25, g - 3)])
    sizes16 = np.diff(b16["plan_graph_node_ptr"].cpu().numpy())
    big = ragged(S2V_CHUNKED_SIZES[0])
    big[[7, 20, 33]] = S2V_CHUNKED_SIZES[1]
    empty = ragged(S2V_EMPTY_BLOCK[0])
    empty[S2V_EMPTY_BLOCK[1]] = 0
    many = {k: ragged(g) for k, g in S2V_MANY_GRAPHS.items()}
    t = min(20, S2V_STEPS)
    one, grid, wide = ("one-block",) * 2, ("grid",) * 2, "grid global-acc"
    return [("b16", sizes16, 14, S2V_STEPS, one),
            ("G24", ragged(24), 14, t, one),
            ("b16 w54", sizes16, 54, t, ("one-block", wide)),
            ("b16 w64", sizes16, 64, t, ("one-block", wide)),
            ("chunked", big, 14, t, ("grid chunked",) * 2),
            ("chunked w54", big, 54, t,
             ("grid chunked", "grid chunked global-acc")),
            (f"G{len(empty)} w54, a block empty", empty, 54, t,
             ("grid", wide)),
            (f"G{len(many['global-acc'])} w32", many["global-acc"], 32, t,
             ("grid", "grid chunked global-acc")),
            (f"G{len(many['spilled-bwd'])} w54", many["spilled-bwd"], 54, t,
             ("grid", "grid chunked global-acc spilled")),
            (f"G{len(many['spilled'])} w64", many["spilled"], 64, t,
             ("grid chunked spilled", "grid chunked global-acc spilled"))]


def _s2v_route_checks(device, gen):
    """Each set2vec route in both softmax modes against set2vec_reference
    and autograd through it: [(line, ok, forward error, backward error)]."""
    import torch
    from mpnn_tpu_torch.kernels import set2vec as S
    b16 = _route_batch16(device)
    out = []
    for name, sizes, w, T, tags in _s2v_route_cases(b16):
        for bsm in (True, False):
            args, leaves = _s2v_sizes_case(sizes, w, gen, device)
            routed = _s2v_tags(args, w, device) == tags
            g = len(sizes)
            cw = torch.randn(g, 2 * w, generator=gen).to(device)
            kw = dict(time_steps=T, batch_softmax=bsm)
            S.reset_launch_counts()
            got = _fwd_and_grads(S.set2vec, args, leaves, cw, kw)
            torch.cuda.synchronize()
            counts = dict(S.launch_counts)
            want = _fwd_and_grads(S.set2vec_reference, args, leaves, cw, kw)
            okf, ef, okb, eb = _fwd_bwd_errors(got, want)
            ok = routed and okf and okb and counts == {"set2vec_fwd": 1,
                                                       "set2vec_bwd": 1}
            out.append((
                f"set2vec {name} (G={g}, nodes {int(args[2].sum())}/"
                f"{args[1].shape[0]} slots, w {w}, T {T}, "
                f"{'global' if bsm else 'per-graph'}; "
                f"{_s2v_route(args, w, device)}"
                f"{'' if routed else f'; expected {tags}'}): fwd {ef:.2e} "
                f"bwd {eb:.2e} {'ok' if ok else 'FAIL'}", ok, ef, eb))
    return out


def _route_batch16(device):
    from mpnn_tpu_torch.train.trainer import batch_to_device
    return batch_to_device(_batch((SMILES * 2)[:16], 16), device)


def phase_att_kernel_check(device):
    """The four attention-family kernels against their plain versions on
    the card: adv widths (f 7, w 14) at batch 1024 and T 100 with the 'att'
    aggregation and the batch-global softmax, then 'adj', the per-graph
    softmax, T 3, and a ragged batch (single-atom molecules, padded edges,
    a padded graph slot); then set2vec's every route (_s2v_route_cases) in
    both softmax modes."""
    import torch
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import set2vec as S
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(41)
    bs, T = ATT_CHECK_BATCH, S2V_STEPS
    big = batch_to_device(_batch((SMILES * 103)[:bs], bs), device)
    ragged = _ragged_att_batch(device)
    cases = [(f"batch{bs} att/global T{T}", big, True, True, T),
             (f"batch{bs} adj/global T{T}", big, False, True, T),
             (f"batch{bs} att/per-graph T{T}", big, True, False, T),
             (f"batch{bs} att/global T3", big, True, True, 3),
             (f"ragged att/global T{T}", ragged, True, True, T),
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
    # fused_att_bwd on every forced launch and the rule's (b1024 and the
    # ragged batch, the correction on and off), twice for the same bits
    routed = []
    for tb, corr in ((big, True), (big, False), (ragged, True)):
        aa, al, _, _ = _att_case(tb, gen, device)
        n, g = int(tb["node_mask"].shape[0]), int(tb["graph_mask"].shape[0])
        cw = torch.randn(n, aa[0].shape[1], generator=gen).to(device)
        kw = dict(with_corr=corr)
        want = _fwd_and_grads(A.fused_att_reference, aa, al, cw, kw)
        for route in ADV_BWD_ROUTES if tb is big and corr else (None,):
            A.reset_launch_counts()
            with _adv_bwd_route(route):
                got = _fwd_and_grads(A.fused_att, aa, al, cw, kw)
                again = _fwd_and_grads(A.fused_att, aa, al, cw, kw)
                torch.cuda.synchronize()
                shape = A.device_bwd_shape(
                    n, A.K.width_bucket("", A.BUCKETS, f=aa[5].shape[1],
                                        K=aa[0].shape[0]),
                    aa[0].shape[0], g, device)
            counts = dict(A.launch_counts)
            _, _, ok_b, eb = _fwd_bwd_errors(got, want)
            same = all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
            ok = ok_b and same and counts == {"fused_att_fwd": 2,
                                              "fused_att_bwd": 2}
            worst["fused_att_bwd"] = max(worst["fused_att_bwd"], eb)
            routed.append(f"{'b' + str(g) if tb is big else 'ragged'} "
                          f"{'att' if corr else 'adj'} {route or 'rule'} "
                          f"({shape.tag()}) {eb:.2e}"
                          + ("" if same else " BITS DIFFER")
                          + ("" if ok else " FAIL"))
            if not ok:
                failed.append(f"fused_att_bwd {route}: {counts}")
    results.append("fused_att_bwd on forced launches (twice for the same "
                   "bits): " + ", ".join(routed))
    for what, ok, ef, eb in _s2v_route_checks(device, gen):
        worst["set2vec_fwd"] = max(worst["set2vec_fwd"], ef)
        worst["set2vec_bwd"] = max(worst["set2vec_bwd"], eb)
        results.append(what)
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
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import set2vec as S
    A.reset_launch_counts()
    AS.reset_launch_counts()
    S.reset_launch_counts()
    _mlp_reset()


def _att_counts():
    """The launch counts of both attention models' six kernels."""
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import set2vec as S
    return {**A.launch_counts, **AS.launch_counts, **S.launch_counts}


def _att_want(model, fwd, bwd):
    """The design's launch counts for `model`: each forward of its path
    `fwd` times, each backward `bwd` times, the other model's kernels
    never."""
    want = dict.fromkeys(ATT_KERNELS + ATTS_KERNELS, 0)
    msg_fwd, msg_bwd = ATT_MODELS[model][1]
    want.update({msg_fwd: fwd, "set2vec_fwd": fwd, msg_bwd: bwd,
                 "set2vec_bwd": bwd})
    return want


def phase_att_serve(device, model="adv"):
    """`predict --experiment adv_classification` (or att_classification)
    as a user runs it, at batch 16 and 1024 from a seeded checkpoint;
    exactly one forward launch of the model's message kernel and one of
    set2vec_fwd per request, no other; logits against the plain path on
    the card, batch by batch (the batch-global softmax and the att model's
    stateless norm couple each batch's molecules). Returns the launch
    counts."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.trainer import batch_to_device
    exp, kernels = ATT_MODELS[model]
    seed = {"adv": 43, "att": 53}[model]
    os.makedirs(OUT_DIR, exist_ok=True)
    probe, ge = G.encode_molgraphs(G.generate_molgraphs(SMILES, [0] * 10))
    cfg = zoo.build(model, afm=ge.atom_width(), bfm=ge.bond_width(),
                    n_out=PS_CLASSES)
    net = network_init(cfg, torch.Generator().manual_seed(seed), "cpu")
    ckpt = os.path.join(OUT_DIR, f"ckpt_{model}.npz")
    save_checkpoint(ckpt, net, meta={"seed": seed, "model": model})
    totals, lines = dict.fromkeys(ATT_KERNELS + ATTS_KERNELS, 0), []
    for bs, rows in ((16, 64), (1024, 3072)):
        csv = _ps_csv(f"new_{model}", rows)
        buf = io.StringIO()
        _att_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", exp, "--data", csv,
                      "--ckpt", ckpt, "--batch-size", str(bs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _att_counts()
        _mlp_take(f"{model} predict at batch {bs}", _nets(cfg.mpnn),
                  counts[kernels[0]], 0)
        recs = [json.loads(x) for x in buf.getvalue().splitlines() if x]
        n_req = -(-rows // bs)
        want = _att_want(model, n_req, 0)
        if counts != want:
            raise RuntimeError(f"{model} predict at batch {bs}: launches "
                               f"{counts}, the design's count is {want}")
        if len(recs) != rows or [r["index"] for r in recs] != list(
                range(rows)):
            raise RuntimeError(f"{model} predict at batch {bs}: "
                               f"{len(recs)} records for {rows}")
        logits = torch.tensor([r["logits"] for r in recs],
                              dtype=torch.float64)
        if not torch.isfinite(logits).all() or any(
                r["pred"] != int(torch.argmax(lg))
                for r, lg in zip(recs, logits)):
            raise RuntimeError(f"{model} predict at batch {bs}: non-finite "
                               "logits or a wrong argmax")
        for k in totals:
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
                     f"launches {kernels[0]} {counts[kernels[0]]} "
                     f"set2vec_fwd {counts['set2vec_fwd']}, {wall:.2f} s "
                     f"wall (featurize+load+serve), logits vs plain path "
                     f"max_abs={mabs:.3e} max_rel={mrel:.3e} "
                     f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{model} batch {bs}: served logits disagree "
                               f"with the plain path ({mabs:.3e})")
    label = {"adv": "att-serve", "att": "atts-serve"}[model]
    print(f"{label}: {exp}; " + "; ".join(lines), flush=True)
    return totals


def phase_att_train(device, model="adv"):
    """The `train` verb of adv_classification (or att_classification) as
    a user runs it (2 epochs at batch 16 on a 4-class CSV), launch counts
    read around it: one launch of each forward and each backward of the
    model's path per step, one of each forward per validation and test
    batch, none of the other model's kernels; the first 3 losses against
    the plain path on the card (rtol 1e-3), and the first step's logits
    and gradients against it (rtol 1e-4 of each one's max abs); then
    `predict` from the last checkpoint. Returns the launch counts."""
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
    exp_name = ATT_MODELS[model][0]
    exp = experiments.get(exp_name)
    csv = _ps_csv(f"train_{model}", TRAIN_ROWS)
    log = os.path.join(OUT_DIR, f"train_{model}.jsonl")
    ckdir = os.path.join(OUT_DIR, f"train_ckpt_{model}")
    if os.path.exists(log):
        os.remove(log)
    buf = io.StringIO()
    _att_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--experiment", exp_name, "--data", csv,
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
    want = _att_want(model, n_steps + n_eval, n_steps)
    _mlp_take(f"{model} train", _nets(zoo.build(model, afm=7, bfm=6).mpnn),
              n_steps + n_eval, n_steps)
    if len(steps) != n_steps or counts != want:
        raise RuntimeError(f"{model} train: {len(steps)} steps, launches "
                           f"{counts}; the design's count is {want}")
    if not (all(math.isfinite(x) for x in steps)
            and math.isfinite(result["test"]["loss"])
            and all(math.isfinite(r["val_loss"]) for r in epochs)):
        raise RuntimeError(f"{model} train: non-finite loss")
    cfg = zoo.build(model, afm=int(gs[0].afm.shape[-1]),
                    bfm=int(gs[0].bfm.shape[-1]), n_out=PS_CLASSES)
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
        raise RuntimeError(f"{model} train: first steps {steps[:3]} vs "
                           f"plain path {plain} (rel {rel:.2e})")
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
        raise RuntimeError(f"{model} train: first step vs plain path, "
                           f"logits {err_l:.2e}, gradients {err_g:.2e} (each"
                           f" divided by its max abs)")
    ckpt = os.path.join(ckdir, f"ckpt_{len(epochs) - 1}.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["predict", "--experiment", exp_name, "--data", csv,
                  "--ckpt", ckpt])
    preds = [json.loads(x) for x in buf.getvalue().splitlines() if x]
    if len(preds) != TRAIN_ROWS or not all(
            math.isfinite(v) for r in preds for v in r["logits"]):
        raise RuntimeError(f"{model}: predict from {ckpt} failed")
    stop = ("" if exp.train.early_stop_loss is None else
            f" (early stop below {exp.train.early_stop_loss})")
    label = {"adv": "att-train", "att": "atts-train"}[model]
    print(f"{label}: {exp_name}, {TRAIN_ROWS} molecules (train "
          f"{len(train_gs)}, val {len(val_gs)}, test {len(test_gs)}), batch "
          f"{bs}, {len(epochs)} epochs, {len(steps)} steps in {wall:.2f} s "
          f"wall; launches {counts} (design: each forward 1 per step and 1 "
          f"per eval batch, each backward 1 per step); step losses first "
          f"{steps[0]:.5f} last {steps[-1]:.5f}; epoch train loss sums "
          f"{[round(r['train_loss'], 4) for r in epochs]}{stop}; test f1 "
          f"{result['test']['f1']:.4f};"
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
    counts as one operation. The function's inputs, not the kernels': the
    edges as vid, src and dst, not the index plan the wrapper builds from
    them."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    g = float(b["graph_mask"].shape[0])
    gemv = 2 * f * 3 * f                            # f → 3f gate GEMV
    att_w = k * f * f + k * f + 2 * f * f + f + 2 * gemv // 2 + 6 * f
    edge_g = 5 * f + f + f                         # gate, g, Σ h0[u]
    node_g = (2 * f * f + f                        # h0·Wh, S_g
              + 5 * f + 2 * f                      # g0, X and g0 ⊙ X
              + 2 * gemv + 15 * f)                 # the GRU
    idx = er * 3 + 2 * nr                # vid, src, dst, mask, node_graph
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
           4 * (3 * nr * f + idx + att_w + nr * f + att_w))
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


def _att_latency(model, bs, device, gen):
    """One attention model at batch `bs` with random weights: its request
    and train-step latency (host clock ending in a device sync, medians of
    20) and, at batch 1024, the device busy time of one profiled train
    step with each of its path's kernels' time in the trace. Returns
    (host batch, device batch, cfg, net, {step_ms, request_ms}, idle
    line)."""
    import statistics
    import torch
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch,
                                              train_step)
    b = _batch((SMILES * (bs // len(SMILES) + 1))[:bs], bs)
    b["labels"] = torch.randint(0, PS_CLASSES, (bs,), generator=gen).numpy()
    tb = batch_to_device(b, device)
    cfg = zoo.build(model, afm=b["node_feats"].shape[1],
                    bfm=b["edge_feats"].shape[1], n_out=PS_CLASSES)
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
    rec = {"step_ms": statistics.median(step_lat),
           "request_ms": statistics.median(req_lat)}
    idle = ""
    if bs == 1024:
        prof, busy, ops, kern = _trace_kernels(
            lambda: float(train_step(net, opt, tb, loss_kind="ce")),
            (*ATT_MODELS[model][1], *ATT_KERNELS[2:], *MLP_KERNELS))
        with open(os.path.join(OUT_DIR, f"profile_{model}_train_1024.txt"),
                  "w") as fh:
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        if min(kern.values()) <= 0:
            raise RuntimeError(f"{model} times: no device time for {kern}")
        mm = _mm_count(prof)
        rprof = _trace(request)
        rbusy, rops = _device_ops(rprof)
        idle = (f"; one train step's device busy {busy:.1f} us in "
                f"{sum(e.count for e in ops)} device ops, {mm} aten::mm, "
                f"idle share {1 - busy / (rec['step_ms'] * 1e3):.3f}, "
                "kernels in the trace " + ", ".join(
                    f"{k} {v:.1f} us" for k, v in kern.items())
                + f"; one request's device busy {rbusy:.1f} us in "
                f"{sum(e.count for e in rops)} device ops, "
                f"{_mm_count(rprof)} aten::mm, idle share "
                f"{1 - rbusy / (rec['request_ms'] * 1e3):.3f}")
    return b, tb, cfg, net, rec, idle


def phase_att_times(device, card):
    """adv at batch 16 and 1024: request latency and train-step latency
    (host clock ending in a device sync), each kernel's time (CUDA events
    over repeated launches on the main path's inputs) beside its bound and
    its plain version's, and the device idle share of one profiled
    batch-1024 train step."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import set2vec as S
    from mpnn_tpu_torch.models.fused_train import _build_att_form
    out, lines, s2v_lines = {}, [], []
    gen = torch.Generator().manual_seed(47)
    for bs in ATT_TIMES_BATCHES:
        b, tb, cfg, net, rec, idle = _att_latency("adv", bs, device, gen)
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
            s2v_lines.append(_s2v_time_line(
                f"adv b{bs}", leaves, x, mask, ng, gnp, meta, device,
                {k: times[k] for k in ("set2vec_fwd", "set2vec_bwd")},
                rec))
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
        for name in ATT_KERNELS:
            rec[name] = dict(ms=times[name], plain_ms=plain[name],
                             bound_ms=bounds[name][0],
                             bound_by=bounds[name][1])
        out[bs] = rec
        lines.append(
            f"adv batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}, vocab {aprime.shape[0]}): request "
            f"median {rec['request_ms']:.3f} ms, train step median "
            f"{rec['step_ms']:.3f} ms (20 reps each){idle}; "
            + ", ".join(
                f"{name} {times[name] * 1e3:.2f} us (events"
                + (f"; with the training stash {t_train[name] * 1e3:.2f} us"
                   if name in t_train else "")
                + f"), plain {plain[name] * 1e3:.1f} us, bound "
                f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.2f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in ATT_KERNELS))
    print(f"att-times [{card}]: " + "; ".join(lines), flush=True)
    s2v_lines += [_s2v_case_times(k, device, gen)
                  for k in ("chunked", "spilled-bwd")]
    print(f"set2vec-routes [{card}]: " + "; ".join(s2v_lines), flush=True)
    return out


def _s2v_phases(stamps, names, reverse):
    """Block 0's mean cycles in each phase of a step, and of the whole step
    (stamp 0 to the next step's stamp 0), from an (T, phases) int64 tensor
    of clock64 stamps; the backward's steps run T − 1 down to 0."""
    st = stamps.cpu().double()
    if reverse:
        st = st.flip(0)
    per = (st[1:, 0] - st[:-1, 0]).mean().item()
    parts = [(st[:, i + 1] - st[:, i]).mean().item()
             for i in range(st.shape[1] - 1)]
    return per, dict(zip(names, parts))


def _s2v_time_line(what, leaves, x, mask, ng, gnp, meta, device, times, rec):
    """One batch's set2vec line: each route, the kernels' times a step,
    the empty-step floor of the forward's grid and combine (timed), and
    one launch's clock64 breakdown of a step into its phases (block 0),
    each phase's share applied to the kernel's time a step. Fills
    rec['set2vec'] with the numbers."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import set2vec as S
    n, g, w = x.shape[0], gnp.shape[0] - 1, x.shape[1]
    T = meta.steps
    floor = _events_ms(lambda p=S.prepare_barrier_floor(n, g, w, T, device):
                       K.launch_prepared(p), 20)
    st_f = torch.zeros(T, S._FWD_PHASES, dtype=torch.int64, device=device)
    m, carry, att = K.launch_prepared(S.prepare_set2vec_fwd(
        leaves, x, mask, ng, gnp, meta, stash=True, stamps=st_f))
    st_b = torch.zeros(T, S._BWD_PHASES, dtype=torch.int64, device=device)
    K.launch_prepared(S.prepare_set2vec_bwd(
        leaves, x, gnp, carry, att, torch.ones_like(m), meta, stamps=st_b))
    torch.cuda.synchronize()
    pf, phf = _s2v_phases(st_f, ("lstm+query", "energies+read", "combine",
                                 "normalise"), False)
    pb, phb = _s2v_phases(st_b, ("stash wait", "pass A", "combine+leaf sums",
                                 "pass B", "VJPs"), True)
    ms_f, ms_b = times["set2vec_fwd"], times["set2vec_bwd"]
    rec["set2vec"] = dict(floor_ms=floor, fwd_step_us=ms_f * 1e3 / T,
                          bwd_step_us=ms_b * 1e3 / T)

    def fmt(per, ph, ms):
        return ", ".join(f"{k} {v / per * ms * 1e3 / T:.2f} us"
                         for k, v in ph.items())
    return (f"{what} ({_s2v_route((None, x, None, None, gnp), w, device)}):"
            f" set2vec_fwd {ms_f * 1e3:.2f} us = {ms_f * 1e3 / T:.2f} us a "
            f"step [{fmt(pf, phf, ms_f)}; {pf:.0f} cycles a step], "
            f"set2vec_bwd {ms_b * 1e3:.2f} us = {ms_b * 1e3 / T:.2f} us a "
            f"step [{fmt(pb, phb, ms_b)}; {pb:.0f} cycles a step]; the "
            f"empty-step floor (the forward's grid and combine, {T} steps) "
            f"{floor * 1e3:.2f} us = {floor * 1e3 / T:.3f} us a step")


def _s2v_case_times(key, device, gen):
    """A route's kernels timed (events) at S2V_STEPS with the batch-global
    softmax: 'chunked' on _s2v_route_cases' chunked batch at w 14,
    'spilled-bwd' on its S2V_MANY_GRAPHS batch at w 54."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import set2vec as S
    cases = _s2v_route_cases(_route_batch16(device))
    name, sizes, w = {"chunked": cases[4], "spilled-bwd": cases[8]}[key][:3]
    args, leaves = _s2v_sizes_case(sizes, w, gen, device)
    rp, x, mask, ng, gnp = args
    with torch.no_grad():
        lv = [t.detach() for t in leaves[:10]]
        meta = S.S2vMeta(S2V_STEPS, True)
        se = S.prepare_set2vec_fwd(lv, x.detach(), mask, ng, gnp, meta,
                                   stash=False)
        st = S.prepare_set2vec_fwd(lv, x.detach(), mask, ng, gnp, meta,
                                   stash=True)
        m, carry, att = K.launch_prepared(st)
        sb = S.prepare_set2vec_bwd(lv, x.detach(), gnp, carry, att,
                                   torch.randn(m.shape, generator=gen)
                                   .to(device), meta)
        times = {"set2vec_fwd": _events_ms(lambda: K.launch_prepared(se),
                                           5, warm=2),
                 "set2vec_bwd": _events_ms(lambda: K.launch_prepared(sb),
                                           5, warm=2)}
        return _s2v_time_line(name, lv, x.detach(), mask, ng, gnp,
                              meta, device, times, {})


# ---------------------------------------------------------------------------
# the T-step attention model att (att_classification): phases 18-21
# ---------------------------------------------------------------------------

# (per-step message tables, state norm, the 'att' aggregation): the att
# model's own first, then the other modes the kernels take
ATTS_MODES = [(True, "stateless", False), (True, "none", False),
              (False, "stateless", False), (True, "stateless", True)]
ATTS_CHECK_BATCH = 1024              # atts-kernel-check's large batch


def _atts_case(tb, gen, device, tm):
    """fused_att_steps' arguments on a device batch, h0 its masked node
    features, Tm random message tables (A' of vid 0 not zero) and a random
    GRU: (args, leaves), every leaf requiring grad."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)
    mask = tb["node_mask"]
    f = int(tb["node_feats"].shape[1])
    k = int(tb["edge_vfirst"].shape[0])
    h0 = (tb["node_feats"] * mask).contiguous()
    gru = {"w_ih": r(f, 3 * f, s=0.3), "w_hh": r(f, 3 * f, s=0.3),
           "b_ih": r(3 * f, s=0.1), "b_hh": r(3 * f, s=0.1)}
    aw = dict(aprime=r(tm, k, f, f, s=0.3), a0=r(tm, f, f, s=0.3),
              qv=r(tm, k, f), q0=r(tm, f), wh=r(tm, f, f, s=0.5))
    leaves = [*aw.values(), h0, *gru.values()]
    for t in leaves:
        t.requires_grad_()
    args = (aw["aprime"], aw["a0"], aw["qv"], aw["q0"], aw["wh"], h0, mask,
            tb["node_graph"], gru, tb["edge_vid"], tb["edge_src"],
            tb["edge_dst"], plan_from_batch(tb))
    return args, leaves


def phase_atts_kernel_check(device):
    """The two att-steps kernels against their plain versions on the card
    (rtol 1e-4, atol 1e-5; gradient leaves divided by their max abs): the
    att model's widths (f 7, T 3) at batch 1024 in the four modes (per-step
    or shared message tables, the stateless norm or none, 'adj' or 'att'),
    and a ragged batch (single-atom molecules, padded edges, a padded graph
    slot) in two; each case also through the serving launch (no
    residuals)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gen = torch.Generator().manual_seed(51)
    b1024 = batch_to_device(_batch((SMILES * 103)[:ATTS_CHECK_BATCH],
                                   ATTS_CHECK_BATCH), device)
    ragged = _ragged_att_batch(device)

    def name(per_step, norm, corr):
        return (f"{'per-step' if per_step else 'shared'}/{norm}/"
                f"{'att' if corr else 'adj'}")
    cases = [(f"batch1024 {name(*m)}", b1024, *m) for m in ATTS_MODES] + [
        (f"ragged {name(*m)}", ragged, *m)
        for m in (ATTS_MODES[0], (False, "none", True))]
    worst = dict.fromkeys(ATTS_KERNELS, 0.0)
    results, failed = [], []
    for what, tb, per_step, norm, corr in cases:
        args, leaves = _atts_case(tb, gen, device, 3 if per_step else 1)
        cw = torch.randn(args[5].shape, generator=gen).to(device)
        kw = dict(steps=3, with_corr=corr, state_norm=norm)
        got = _fwd_and_grads(AS.fused_att_steps, args, leaves, cw, kw)
        torch.cuda.synchronize()
        want = _fwd_and_grads(AS.fused_att_steps_reference, args, leaves, cw,
                              kw)
        ok_f, ef, ok_b, eb = _fwd_bwd_errors(got, want)
        with torch.no_grad():
            served = AS.fused_att_steps(*args, **kw)
        torch.cuda.synchronize()
        ok_s, es, _ = _within(served, want[0])
        worst["fused_att_steps_fwd"] = max(worst["fused_att_steps_fwd"], ef,
                                           es)
        worst["fused_att_steps_bwd"] = max(worst["fused_att_steps_bwd"], eb)
        ok = ok_f and ok_b and ok_s
        n, g = int(tb["node_mask"].shape[0]), int(tb["graph_mask"].shape[0])
        results.append(
            f"{what} (nodes {int(tb['node_mask'].sum())}/{n} slots, G={g}, "
            f"edges {int(tb['edge_mask'].sum())}/{tb['edge_src'].shape[0]}):"
            f" fwd {ef:.2e} (serving {es:.2e}) bwd {eb:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)
    print(f"atts-kernel-check: fused_att_steps_fwd/bwd vs "
          f"fused_att_steps_reference and autograd through it (T 3; "
          f"cotangent Σ h·c; forward max abs error, rtol {RTOL} atol "
          f"{ATOL}; gradient leaves divided by their max abs, max error, "
          f"rtol {RTOL} atol {ATOL}): " + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"att-steps kernels disagree with their plain "
                           f"versions: {failed}")
    # the backward on every route of its rule and the rule's own, at b1024
    # and b16 (per-step tables, the stateless norm, 'att'; b16 also shared
    # tables without a norm), each twice for the same bits
    b16 = batch_to_device(_batch((SMILES * 2)[:16], 16), device)
    lines = []
    for what, tb, per_step, norm, corr in (
            ("b1024", b1024, True, "stateless", True),
            ("b16", b16, True, "stateless", True),
            ("b16", b16, False, "none", True)):
        args, leaves = _atts_case(tb, gen, device, 3 if per_step else 1)
        cw = torch.randn(args[5].shape, generator=gen).to(device)
        kw = dict(steps=3, with_corr=corr, state_norm=norm)
        want = _fwd_and_grads(AS.fused_att_steps_reference, args, leaves, cw,
                              kw)
        n, k = args[5].shape[0], args[0].shape[1]
        for route in ATTS_BWD_ROUTES:
            AS.reset_launch_counts()
            with _att_bwd_route(route):
                shape = AS.device_bwd_shape(n, "", args[0].shape[0], k, 3,
                                            norm == "stateless", device)
                got = _fwd_and_grads(AS.fused_att_steps, args, leaves, cw,
                                     kw)
                again = _fwd_and_grads(AS.fused_att_steps, args, leaves, cw,
                                       kw)
            torch.cuda.synchronize()
            _, _, ok_b, eb = _fwd_bwd_errors(got, want)
            same = all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
            ok = (ok_b and same and AS.launch_counts["fused_att_steps_bwd"]
                  == 2)
            worst["fused_att_steps_bwd"] = max(worst["fused_att_steps_bwd"],
                                               eb)
            lines.append(f"{what} {name(per_step, norm, corr)} "
                         f"{route or 'rule'} ({shape.tag()}) bwd {eb:.2e}"
                         f"{'' if ok else ' FAIL'}")
            if not ok:
                failed.append(f"{what} {route}")
    print(f"atts-kernel-check: fused_att_steps_bwd's routes vs autograd "
          f"through fused_att_steps_reference (leaves divided by their max "
          f"abs, rtol {RTOL} atol {ATOL}; two runs, the same bits; one "
          f"launch each): " + "; ".join(lines), flush=True)
    if failed:
        raise RuntimeError(f"fused_att_steps_bwd disagrees on a route: "
                           f"{failed}")
    return worst


def _atts_bounds(b, f, k, T, tm, with_corr, stateless):
    """Least times of the two att-steps kernels' work on this batch, each
    the larger of its float32 operations over the peak CUDA-core rate and
    its bytes (each input read once, each output written once; the
    training residuals — Tm message slots, T pre-norm states, T means and
    vars — written by the forward and read by the backward) over HBM
    bandwidth. Real nodes and edges. The forward as the serving path runs
    it (no residuals); a transcendental counts as one operation. The
    function's inputs, not the kernels': the edges as vid, src and dst,
    not the index plan the wrapper builds from them."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    gemv = 2 * f * 3 * f                            # f → 3f gate GEMV
    corr = 1 if with_corr else 0
    weights = tm * (k * f * f + 2 * f * f + k * f + f) + 6 * f * f + 6 * f
    idx = er * 3 + 2 * nr                # vid, src, dst, mask, node_graph
    # per message step: the gate (5f), g (f), A'·g per edge, Σ h0[u] for
    # the correction; h0·Wh per node, and S_g, g0, X, g0 ⊙ X and A0·(g0 ⊙ X)
    edge_f = 6 * f + corr * f + 2 * f * f
    node_f = 2 * f * f + corr * (f + 5 * f + 2 * f + 2 * f * f)
    # per step and node: the GRU (two gate GEMVs, the blend) and the
    # stateless norm (Σx, Σ(x − m)², the normalization)
    chain_f = 2 * gemv + 15 * f + (6 * f if stateless else 0)
    fwd = (tm * (er * edge_f + nr * node_f) + T * nr * chain_f,
           4 * (nr * f + idx + weights + nr * f))
    resid = tm * nr * f + T * nr * f + 2 * T * f
    # backward, per step and node: the norm VJP with its two batch sums
    # (8f), the gate pre-activations recomputed (2 GEMVs) and their VJP
    # (2 transposed GEMVs, 2 outer products, ~35f); per message step and
    # edge: the gate and g recomputed (6f), A'ᵀ·dm (2f²), the softmax VJP
    # (6f), ∂A' (2f²), ∂qv and ∂h0[u] (f each), and the correction's Σ
    # h0[u] and −dX at the source (3f); per message step and node: h0·Wh
    # recomputed, ∂Wh and Wh·dz (2f² each), Σ dz (f), and the
    # correction's A0ᵀ·dm, ∂A0 (2f² each), g0 and its VJP (~13f)
    chain_b = 6 * gemv + 35 * f + (8 * f if stateless else 0)
    edge_b = 6 * f + 4 * f * f + 8 * f + corr * 3 * f
    node_b = 6 * f * f + f + corr * (4 * f * f + 13 * f)
    bwd = (T * nr * chain_b + tm * (er * edge_b + nr * node_b),
           4 * (nr * f + resid + nr * f + idx + weights + nr * f
                + weights))
    out = {}
    for name, (ops, nbytes) in zip(ATTS_KERNELS, (fwd, bwd)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def phase_atts_times(device, card):
    """att at batch 16 and 1024: request and train-step latency (host
    clock ending in a device sync), the two att-steps kernels' times (CUDA
    events over repeated launches on the main path's inputs; the forward
    as serving runs it, and with the training residuals) beside their
    bounds and their plain versions' times, and the device idle share of
    one profiled batch-1024 train step (set2vec's kernels are timed in
    att-times)."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models.fused_train import _build_att_form_steps
    out, lines = {}, []
    gen = torch.Generator().manual_seed(59)
    for bs in (16, 1024):
        b, tb, cfg, net, rec, idle = _att_latency("att", bs, device, gen)
        c = cfg.mpnn
        meta = AS.AttsMeta(c.message_steps, c.aggregation == "att",
                           c.state_norm == "stateless")
        kw = dict(steps=meta.steps, with_corr=meta.with_corr,
                  state_norm=c.state_norm)
        mask, ng = tb["node_mask"], tb["node_graph"]
        batch = (tb["edge_vid"], tb["edge_src"], tb["edge_dst"],
                 plan_from_batch(tb))
        # the kernels alone, on the inputs the main path gives them
        with torch.no_grad():
            h0 = (tb["node_feats"] * mask).contiguous()
            form = _build_att_form_steps(net.mpnn, tb)
            gru = {k: v.detach() for k, v in net.mpnn.gru.as_dict().items()}
            weights = list(zip(AS._GRAD_LEAVES, (
                *form, gru["w_ih"], gru["w_hh"], gru["b_ih"], gru["b_hh"])))
            pe = AS.prepare_fused_att_steps_fwd(weights, h0, mask, ng,
                                                *batch, meta, train=False)
            pt = AS.prepare_fused_att_steps_fwd(weights, h0, mask, ng,
                                                *batch, meta, train=True)
            times = {"fused_att_steps_fwd": _events_ms(
                lambda: K.launch_prepared(pe), 100)}
            t_train = _events_ms(lambda: K.launch_prepared(pt), 100)
            plain = {"fused_att_steps_fwd": _events_ms(
                lambda: AS.fused_att_steps_reference(*form, h0, mask, ng,
                                                     gru, *batch, **kw), 10)}
            h, msgs, htil, stats = K.launch_prepared(pt)
            gh = torch.randn(h.shape, generator=gen).to(device)
            pb = AS.prepare_fused_att_steps_bwd(weights, h0, msgs, htil,
                                                stats, gh, *batch, meta)
            times["fused_att_steps_bwd"] = _events_ms(
                lambda: K.launch_prepared(pb), 100)
        leaves = [t.clone().requires_grad_() for _, t in weights] + [
            h0.clone().requires_grad_()]
        h_ref = AS.fused_att_steps_reference(
            *leaves[:5], leaves[9], mask, ng,
            dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), leaves[5:9])),
            *batch, **kw)
        obj = (h_ref * gh).sum()
        plain["fused_att_steps_bwd"] = _events_ms(lambda: torch.autograd.grad(
            obj, leaves, retain_graph=True, allow_unused=True), 5)
        bounds = _atts_bounds(b, c.node_features, form[0].shape[1],
                              meta.steps, form[0].shape[0], meta.with_corr,
                              meta.stateless)
        for name in ATTS_KERNELS:
            rec[name] = dict(ms=times[name], plain_ms=plain[name],
                             bound_ms=bounds[name][0],
                             bound_by=bounds[name][1])
        out[bs] = rec
        lines.append(
            f"att batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}, vocab {form[0].shape[1]}, Tm "
            f"{form[0].shape[0]}): request median {rec['request_ms']:.3f} "
            f"ms, train step median {rec['step_ms']:.3f} ms (20 reps each)"
            f"{idle}; " + ", ".join(
                f"{name} {times[name] * 1e3:.2f} us (events"
                + (f"; with the training residuals {t_train * 1e3:.2f} us"
                   if name == "fused_att_steps_fwd" else "")
                + f"), plain {plain[name] * 1e3:.1f} us, bound "
                f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.2f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in ATTS_KERNELS))
    print(f"atts-times [{card}]: " + "; ".join(lines), flush=True)
    return out


# ---------------------------------------------------------------------------
# the edge-MLP chain kernels (all five models' A-form builds) and the wide
# width buckets: phases 22-24
# ---------------------------------------------------------------------------

def _mlp_cases(device, gen):
    """(what, rows, head weights, head biases, W_s) of the chain at the
    shapes the main paths give it — each model's edge network on its b1024
    batch's vocab rows (K + 1), the encoded model's encoded rows at ef 2 —
    and at the design points the zoo produces at real widths: pf 49 (bfm
    7), 64 (bfm 8) and 256 (bfm 4 at f 19, W_s past shared memory)."""
    import torch
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.ops.message import edge_mlp_head_dims
    from mpnn_tpu_torch.train.trainer import batch_to_device
    tb = batch_to_device(_batch((SMILES * 103)[:1024], 1024), device)
    afm, bfm = tb["node_feats"].shape[1], tb["edge_feats"].shape[1]
    rows = torch.cat([tb["edge_feats"][tb["edge_vfirst"].long()],
                      tb["edge_feats"].new_zeros(1, bfm)])
    cases = []
    for model in ("lipo", "adv", "att"):
        cfg = (zoo.lipo(afm, bfm, tb["node_nafm"].shape[1]) if model == "lipo"
               else zoo.build(model, afm=afm, bfm=bfm, n_out=4))
        mp = network_init(cfg, gen, device).mpnn.message[0]
        cases.append((f"{model} b1024", rows,
                      [l.weight.detach().t().contiguous() for l in mp.head],
                      [l.bias.detach() for l in mp.head],
                      mp.shared.weight.detach().t().contiguous()))

    def synthetic(what, n, ef, nf):
        head, pf = edge_mlp_head_dims(ef, nf, nf)
        r = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen)
                                   * s).to(device)
        x = r(n, ef)
        x[-1] = 0.0
        # W_s = s·(0.7·I + 0.3·Q), Q a random rotation, s the first scale
        # that keeps the output within 0.3-30: the relus cut about half
        # the features, float32 rounding stays near 1e-6 over 50 steps
        # (tests/test_torch_gpu.py::mlp_chain)
        ws, bs = [r(i, o, s=i ** -0.5) for i, o in head], [
            r(o, s=0.1) for _, o in head]
        base = (0.7 * torch.eye(pf) + 0.3 * torch.linalg.qr(
            torch.randn(pf, pf, generator=gen))[0]).to(device)
        for scale in [0.9 + 0.05 * i for i in range(22)]:
            pen = M.edge_mlp_reference(x, ws, bs, scale * base, 50)
            if 0.3 <= float(pen.abs().max()) <= 30:
                break
        return what, x, ws, bs, scale * base
    # every route of kernels/edge_mlp.py::launch_shape on an H100: the
    # register route in one block (the models' R 9, pf 16) and in several
    # (pf 49, 64), only the zero row; the panel route in one block (pf
    # 81), in clusters of 2 (pf 144's backward, pf 256's forward) and of
    # 4 (pf 256's backward), 17 clusters each; the l2 route past what a
    # cluster of 8 holds (pf 484's backward beside its forward in a
    # cluster of 8; pf 625 both ways)
    cases += [synthetic("encoded (ef 2, pf 16)", rows.shape[0], 2, 8),
              synthetic("bfm 7 (pf 49)", 65, 7, 10),
              synthetic("bfm 8 (pf 64)", 65, 8, 32),
              synthetic("bfm 4 at f 19 (pf 256)", 65, 4, 19),
              synthetic("the zero row alone (pf 36)", 1, 6, 7),
              synthetic("bfm 3 (pf 81)", 65, 3, 10),
              synthetic("ef 12 (pf 144)", 65, 12, 13),
              synthetic("bfm 22 at f 23 (pf 484)", 9, 22, 23),
              synthetic("bfm 5 at f 26 (pf 625)", 9, 5, 26)]
    return cases


def phase_mlp_kernel_check(device):
    """The edge-MLP chain kernels against edge_mlp_reference on the card,
    T 50: the forward (rtol 1e-4, atol 1e-5 of the output's max abs: the
    chain's scale depends on its weights) and the gradient of Σ pen·c in
    the rows and every weight through the backward kernel against autograd
    through the plain version, each leaf divided by its max abs."""
    import torch
    from mpnn_tpu_torch.kernels import edge_mlp as M
    gen = torch.Generator().manual_seed(61)
    worst_f, worst_b, lines, failed = 0.0, 0.0, [], []
    for what, x, ws, bs, sw in _mlp_cases(device, gen):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs, sw)]
        h = len(ws)
        c = torch.randn(x.shape[0], sw.shape[0], generator=gen).to(device)
        res = []
        for fn in (M.edge_mlp, M.edge_mlp_reference):
            M.reset_launch_counts()
            pen = fn(leaves[0], leaves[1:1 + h], leaves[1 + h:1 + 2 * h],
                     leaves[-1], tail=50)
            gr = torch.autograd.grad((pen * c).sum(), leaves)
            torch.cuda.synchronize()
            res.append((pen.detach(), gr, dict(M.launch_counts)))
        if res[0][2] != {"edge_mlp_fwd": 1, "edge_mlp_bwd": 1}:
            raise RuntimeError(f"mlp-kernel-check {what}: launches "
                               f"{res[0][2]}")
        scale = float(res[1][0].abs().max()) or 1.0
        ok_f, err_f, _ = _within(res[0][0] / scale, res[1][0] / scale)
        _, _, ok_b, err_b = _fwd_bwd_errors(
            (res[0][0], list(res[0][1])), (res[1][0], list(res[1][1])))
        if what.endswith("b1024"):            # the main paths' shapes
            worst_f = max(worst_f,
                          float((res[0][0] - res[1][0]).abs().max()))
        worst_b = max(worst_b, err_b)
        pf = sw.shape[0]
        routes = " / ".join(M.device_shape(
            d, x.shape[0], [x.shape[1]] + [w.shape[1] for w in ws], 50,
            device).tag() for d in ("fwd", "bwd"))
        lines.append(f"{what} (R {x.shape[0]}, H {h}, pf {pf}; {routes}): "
                     f"fwd max_abs "
                     f"{err_f * scale:.3e} of max {scale:.3e}, bwd "
                     f"max_scaled {err_b:.3e} "
                     f"{'ok' if ok_f and ok_b else 'FAIL'}")
        if not (ok_f and ok_b and torch.isfinite(res[0][0]).all()):
            failed.append(what)
    print("mlp-kernel-check: edge_mlp_fwd vs edge_mlp_reference, "
          "edge_mlp_bwd vs autograd through it (T 50; forward rtol "
          f"{RTOL} atol {ATOL} of its max abs; each gradient leaf divided "
          f"by its max abs, rtol {RTOL} atol {ATOL}): " + "; ".join(lines),
          flush=True)
    if failed:
        raise RuntimeError(f"edge-MLP kernels disagree with their plain "
                           f"version: {failed}")
    return {"edge_mlp_fwd": worst_f, "edge_mlp_bwd": worst_b}


def _mlp_bounds(rows, dims, tail):
    """Least times of the chain's forward and backward: 2·R·(Σ head
    in·out + T·pf²) multiply-adds for the forward, twice that for the
    backward (∂W and the cotangent of every layer; ∂x is the first head
    layer's); bytes: the rows, the weights and the output, read or written
    once (the backward also the cotangent in and the gradients out)."""
    pf = dims[-1]
    macs = sum(i * o for i, o in zip(dims[:-1], dims[1:])) + tail * pf * pf
    weights = sum(i * o + o for i, o in zip(dims[:-1], dims[1:])) + pf * pf
    out = {}
    for name, ops, nbytes in (
            ("edge_mlp_fwd", 2 * rows * macs,
             4 * (rows * dims[0] + weights + rows * pf)),
            ("edge_mlp_bwd", 4 * rows * macs,
             4 * (2 * rows * dims[0] + 2 * weights + rows * pf))):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


# the empty-chain floor runs as one launch of this many chains' layers
MLP_FLOOR_REPEAT = 100


def _mlp_detail(x, ws, bs, sw, g, f_ms, b_ms):
    """One chain's device times, empty-chain floor and clock64 phases:
    each kernel's device time a launch from a torch.profiler trace of 20
    launches (CUDA events over back-to-back launches also hold the host's
    launch gap, which a kernel of a few us does not cover); the floor
    kernels (the launch's grid, block, cluster and shared memory, H + T
    forward and 2·(H + T) backward barrier-separated empty layers; timed
    with events as one launch of MLP_FLOOR_REPEAT times as many layers,
    divided by it, so that no launch gap is in it); and one launch of each kernel with block
    0's thread 0 stamping its phases (cycles; the probe is tail layer T /
    2: its input row's loads alone, the dot with its loads and stores, the
    barrier). Returns (text, numbers)."""
    import torch
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.kernels import fused_step as K
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    rows, layers, dev = x.shape[0], len(ws) + 50, x.device
    fwd = M.prepare_edge_mlp_fwd(x, ws, bs, sw, tail=50)
    bwd = M.prepare_edge_mlp_bwd(x, ws, bs, sw, g, tail=50)
    dev_us = {p.name: t / 20 for p, t in zip(
        (fwd, bwd), _kernel_trace_us_n(20, fwd, bwd))}
    rep = MLP_FLOOR_REPEAT
    floor = {d: _events_ms(lambda d=d, n=n: M.launch_floor(
        d, rows, dims, 50, rep * n, dev), 5) / rep
        for d, n in (("fwd", layers), ("bwd", 2 * layers))}
    st = {d: torch.zeros(M.PROF_SLOTS, dtype=torch.int64, device=dev)
          for d in ("fwd", "bwd")}
    K.launch_prepared(M.prepare_edge_mlp_fwd(x, ws, bs, sw, tail=50,
                                             prof=st["fwd"]))
    K.launch_prepared(M.prepare_edge_mlp_bwd(x, ws, bs, sw, g, tail=50,
                                             prof=st["bwd"]))
    torch.cuda.synchronize()
    f, b = st["fwd"].tolist(), st["bwd"].tolist()
    ph = {"fwd": {"stage": f[1] - f[0], "chain": f[7] - f[1],
                  "layer": (f[7] - f[1]) / layers,
                  "probe loads": f[4] - f[3], "probe dot": f[5] - f[4],
                  "probe barrier": f[6] - f[5], "write": f[8] - f[7],
                  "total": f[8] - f[0]},
          "bwd": {"stage": b[1] - b[0], "recompute": b[7] - b[1],
                  "reverse start": b[8] - b[7], "walk": b[13] - b[8],
                  "walk layer": (b[13] - b[8]) / 50,
                  "probe loads": b[10] - b[9], "probe dot": b[11] - b[10],
                  "probe barrier": b[12] - b[11], "dW_s": b[14] - b[13],
                  "head": b[15] - b[14], "combine": b[16] - b[15],
                  "total": b[16] - b[0]}}
    text = (f"device time (trace) fwd {dev_us['edge_mlp_fwd']:.2f} us, "
            f"bwd {dev_us['edge_mlp_bwd']:.2f} us; empty-chain floor fwd "
            f"{floor['fwd'] * 1e3:.3f} us ({layers} layers), bwd "
            f"{floor['bwd'] * 1e3:.3f} us ({2 * layers}); block 0 clock64 "
            f"cycles: " + "; ".join(
                f"{d} [" + ", ".join(f"{k} {v:.0f}" for k, v in p.items())
                + "]" for d, p in ph.items()))
    return text, {"device_us": dev_us, "floor_ms": floor, "cycles": ph}


def phase_mlp_times(device, card):
    """Each chain kernel's time (CUDA events over 200 launches, as every
    other row's; beside it the device time in a trace) at the shapes of
    mlp-kernel-check's cases, beside its bound, its plain
    version's time (the 51-layer chain of torch.mm; the backward autograd
    through it), its launch shape, the empty-chain floor of that launch and
    block 0's clock64 phases (_mlp_detail). The lipo b1024 case is the main
    path's row. Writes every number to $MPNN_SMOKE_OUT/mlp_times.json."""
    import torch
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.kernels import fused_step as K
    gen = torch.Generator().manual_seed(62)
    out, lines = {}, []
    for what, x, ws, bs, sw in _mlp_cases(device, gen):
        g = torch.randn(x.shape[0], sw.shape[0], generator=gen).to(device)
        pf_ = M.prepare_edge_mlp_fwd(x, ws, bs, sw, tail=50)
        pb_ = M.prepare_edge_mlp_bwd(x, ws, bs, sw, g, tail=50)
        f_ms = _events_ms(lambda: K.launch_prepared(pf_), 200)
        b_ms = _events_ms(lambda: K.launch_prepared(pb_), 200)
        with torch.no_grad():
            pfw_ms = _events_ms(lambda: M.edge_mlp_reference(
                x, ws, bs, sw, 50), 20)
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs, sw)]
        h = len(ws)
        pen = M.edge_mlp_reference(leaves[0], leaves[1:1 + h],
                                   leaves[1 + h:1 + 2 * h], leaves[-1], 50)
        pbw_ms = _events_ms(lambda: torch.autograd.grad(
            pen, leaves, g, retain_graph=True), 20)
        dims = [x.shape[1]] + [w.shape[1] for w in ws]
        bounds = _mlp_bounds(x.shape[0], dims, 50)
        detail, nums = _mlp_detail(x, ws, bs, sw, g, f_ms, b_ms)
        routes = {d: M.device_shape(d, x.shape[0], dims, 50, device).tag()
                  for d in ("fwd", "bwd")}
        # a kernel's time: events over back-to-back launches, as every
        # row's; a ~10 us kernel's events also hold the host's launch gap,
        # so its device time in a trace stands beside them (trace_ms)
        dev = nums["device_us"]
        out[what] = {
            "edge_mlp_fwd": dict(ms=f_ms, trace_ms=dev["edge_mlp_fwd"] / 1e3,
                                 plain_ms=pfw_ms),
            "edge_mlp_bwd": dict(ms=b_ms, trace_ms=dev["edge_mlp_bwd"] / 1e3,
                                 plain_ms=pbw_ms),
            "routes": routes, **nums}
        for name in MLP_KERNELS:
            bound, by, _, _ = bounds[name]
            out[what][name].update(bound_ms=bound, bound_by=by)
        lines.append(
            f"{what} (R {x.shape[0]}, dims {dims}; {routes['fwd']} / "
            f"{routes['bwd']}): " + ", ".join(
                f"{n} {out[what][n]['ms'] * 1e3:.2f} us (events; trace "
                f"{out[what][n]['trace_ms'] * 1e3:.2f} us), plain "
                f"{out[what][n]['plain_ms'] * 1e3:.1f} us, bound "
                f"{bounds[n][0] * 1e3:.3f} us by {bounds[n][1]} "
                f"({bounds[n][2] / 1e6:.2f} Mop, {bounds[n][3] / 1e6:.4f} "
                f"MB)" for n in MLP_KERNELS) + f"; {detail}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "mlp_times.json"), "w") as fh:
        json.dump({"card": card, "cases": out}, fh, indent=1)
    print(f"mlp-times [{card}] (T 50; events over 200 launches, device "
          f"time in a trace of 20): " + "; ".join(lines), flush=True)
    return out["lipo b1024"]


# drug-like SMILES over many elements, charges and aromatic rings; they
# featurize to afm 27 and bfm 6 (tests/test_torch_gpu.py::WIDE_SMILES)
WIDE_SMILES = [
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O=C(O)c1ccccc1OC(C)=O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "C1=CC=C(C=C1)[N+](=O)[O-]",
    "FC(F)(F)c1ccc(Cl)cc1Br", "Ic1ccc(cc1)S(=O)(=O)N", "CP(=O)(O)O",
    "B(O)(O)c1ccccc1", "C[Si](C)(C)OC", "[Na+].[Cl-]", "C[Se]C",
    "[NH4+]", "O=[As](O)(O)O", "[K+].[I-]", "c1ccc2[nH]ccc2c1",
    "C1CCNCC1", "OC[C@H]1OC(O)[C@H](O)[C@@H](O)[C@@H]1O", "[Li+].[F-]",
    "[Mg+2].[O-]C(=O)C", "Cl[Sn](Cl)(Cl)Cl", "[Zn+2]", "[Ca+2]",
    "[Al](Cl)(Cl)Cl",
]
WIDE_ROWS = 184
# model → (experiment, the kernels its serving and training launch)
STEP_KERNELS = ("fused_eval", "fused_step_fwd", "fused_step_bwd")
WIDE_MODELS = {
    "lipo": ("lipo", STEP_KERNELS),
    "basic": ("basic_classification", STEP_KERNELS),
    "graph_norm": ("graph_norm_classification", PS_KERNELS),
    "adv": ("adv_classification", ATT_KERNELS),
    "att": ("att_classification", (*ATTS_KERNELS, *ATT_KERNELS[2:])),
}


def _wide_counts():
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    return {**K.launch_counts, **P.launch_counts, **_att_counts(),
            **M.launch_counts}


def _wide_reset():
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    K.reset_launch_counts()
    P.reset_launch_counts()
    _att_reset()


def _wide_csv(model, task, label_col, smiles=None, rows=None,
              classes=PS_CLASSES, prefix="wide"):
    """A CSV of `rows` molecules cycling through `smiles` (default the
    wide set's WIDE_ROWS), labels a sine (mse) or random classes, each of
    the first `classes` rows its own class."""
    import numpy as np
    rows = WIDE_ROWS if rows is None else rows
    smiles = WIDE_SMILES if smiles is None else smiles
    csv = os.path.join(OUT_DIR, f"{prefix}_{model}.csv")
    smiles = (smiles * (rows // len(smiles) + 1))[:rows]
    rng = np.random.RandomState(rows)
    with open(csv, "w") as fh:
        fh.write(f"smiles,{label_col}\n")
        for i, sm in enumerate(smiles):
            y = (0.8 * math.sin(0.7 * i) if task == "mse"
                 else (i % classes if i < classes
                       else rng.randint(classes)))
            fh.write(f"{sm},{y}\n")
    return csv


def _kernel_device_us(prof):
    """{kernel: device µs} of the port's kernels in a trace."""
    out = {}
    for e in _device_ops(prof)[1]:
        m = re.search(r"((?:fused|set2vec|edge_mlp)[a-z_0-9]*)_kernel",
                      e.key)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + getattr(
                e, "self_device_time_total", 0.0)
    return out


def _verb_run(what, model, exp, kernels, cfg, csv, rows, task, n_out,
              serve_bs, serving_net, device, files):
    """One model through the verbs on the card: `predict` of the CSV's
    `rows` molecules at each batch of serve_bs from a seeded checkpoint
    (every norm random where serving_net) against the plain path on the
    same batches, one launch of each serving kernel (and of the edge-MLP
    forward per message network) per request; the `train` verb for one
    epoch at batch 16, one launch of each forward and backward per step,
    its first 3 losses against the plain path (rtol 1e-3); the first
    step's outputs and every parameter gradient, kernels against the plain
    path, each divided by its max abs (rtol 1e-4, atol 1e-5); each
    kernel's device time in a trace of one request and one train step.
    The experiment's transforms (graphs/filters.py) apply to both paths.
    Returns (a report, the predict launches, the train launches)."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import (batch_to_device, ce_loss,
                                              eval_step_for_batch, mse_loss,
                                              train_step)
    mc = cfg.mpnn
    widths = (f"f {mc.node_features}, od {mc.output_dim}"
              + (f", set2vec w {2 * mc.node_features}"
                 if mc.readout == "set2vec" else ""))
    nets = _nets(mc)

    def dataset():
        return cli.apply_experiment_transforms(exp, (
            G.load_number_dataset(csv, "smiles", exp.label_col)[0]
            if task == "mse" else G.load_classification_dataset(
                csv, "smiles", exp.label_col)[0]))
    gen = torch.Generator().manual_seed(71)
    net = (_serving_net(gen, cfg, "cpu") if serving_net
           else network_init(cfg, gen, "cpu"))
    ckpt = os.path.join(OUT_DIR, f"ckpt_{files}.npz")
    save_checkpoint(ckpt, net, meta={"seed": 71, "model": model})
    # serving launches the eval kernel of the shared and per-step
    # families, the forward kernels of the attention families; training
    # the training forward (the attention families: the same forward)
    # per step and the eval kernel per validation and test batch
    evals = {"fused_eval", "fused_psteps_eval"}
    train_fwd = {"fused_step_fwd", "fused_psteps_fwd"}
    serve = [k for k in kernels
             if k in evals or not (k.endswith("_bwd") or k in train_fwd)]
    serve_counts, serve_errs = {}, []
    for sbs in serve_bs:
        buf = io.StringIO()
        _wide_reset()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", exp.name, "--data",
                      csv, "--ckpt", ckpt, "--batch-size", str(sbs)])
        torch.cuda.synchronize()
        counts = _wide_counts()
        n_req = -(-rows // sbs)
        want = {k: (n_req if k in serve else 0) for k in kernels}
        want.update(edge_mlp_fwd=nets * n_req, edge_mlp_bwd=0)
        if any(counts[k] != v for k, v in want.items()):
            raise RuntimeError(f"{what} predict at {sbs}: launches "
                               f"{ {k: counts[k] for k in want} }, "
                               f"the design's count is {want}")
        recs = [json.loads(x) for x in buf.getvalue().splitlines()
                if x]
        key = "pred" if task == "mse" else "logits"
        got = torch.tensor([r[key] for r in recs], dtype=torch.float64)
        loader = G.GraphLoader(dataset(), sbs, collate="packed")
        pnet, _ = load_checkpoint(ckpt, cfg, device=device)
        with torch.no_grad():
            plain = torch.cat([
                network_apply_packed(pnet, batch_to_device(b, device),
                                     fused=False)[
                    :int(b["graph_mask"].sum())].reshape(
                        -1, 1 if task == "mse" else n_out).cpu()
                for b in loader]).to(torch.float64)
        ok_s, err_s, _ = _within(got.reshape(plain.shape), plain)
        if not (ok_s and torch.isfinite(got).all()):
            raise RuntimeError(f"{what} predict at {sbs} vs plain "
                               f"path: {err_s:.3e}")
        for k in want:
            serve_counts[k] = serve_counts.get(k, 0) + counts[k]
        serve_errs.append(f"b{sbs} {n_req} requests max_abs "
                          f"{err_s:.3e}")
    loader = G.GraphLoader(dataset(), serve_bs[0], collate="packed")
    # training: the verb, then the plain path's first 3 steps
    log = os.path.join(OUT_DIR, f"{files}_train.jsonl")
    if os.path.exists(log):
        os.remove(log)
    bs = 16
    _wide_reset()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["train", "--experiment", exp.name, "--data", csv,
                  "--epochs", "1", "--batch-size", str(bs),
                  "--ckpt-dir", os.path.join(OUT_DIR,
                                             f"{files}_ckpt"),
                  "--log", log])
    torch.cuda.synchronize()
    counts = _wide_counts()
    with open(log) as fh:
        steps = [json.loads(x)["loss"] for x in fh
                 if x.strip() and '"step"' in x]
    train_gs, test_gs = train_test_split(dataset(), 0.1, 317)
    train_gs, val_gs = train_test_split(train_gs, 0.1, 317)
    n_steps = -(-len(train_gs) // bs)
    n_eval = -(-len(val_gs) // bs) + -(-len(test_gs) // bs)
    want = {k: (n_eval if k in evals else
                n_steps if k in train_fwd or k.endswith("_bwd") else
                n_steps + n_eval) for k in kernels}
    want.update(edge_mlp_fwd=nets * (n_steps + n_eval),
                edge_mlp_bwd=nets * n_steps)
    if len(steps) != n_steps or any(counts[k] != v
                                    for k, v in want.items()):
        raise RuntimeError(f"{what} train: {len(steps)} steps, "
                           f"launches "
                           f"{ {k: counts[k] for k in want} }, the "
                           f"design's count is {want}")
    tnet = network_init(cfg, torch.Generator().manual_seed(317), device)
    opt = adam(tnet.parameters(), exp.train.learning_rate,
               weight_decay=exp.train.weight_decay)
    plain_steps = []
    for b in G.GraphLoader(train_gs, bs, shuffle=True, seed=317):
        if len(plain_steps) == 3:
            break
        plain_steps.append(float(train_step(
            tnet, opt, batch_to_device(b, device), fused=False,
            loss_kind=task)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3],
                                                  plain_steps))
    if not (all(math.isfinite(x) for x in steps) and rel <= 1e-3):
        raise RuntimeError(f"{what} train: first steps "
                           f"{steps[:3]} vs plain {plain_steps}")
    # the first step's outputs and gradients, kernels vs plain
    tb = batch_to_device(next(iter(G.GraphLoader(
        train_gs, bs, shuffle=True, seed=317))), device)
    tnet = network_init(cfg, torch.Generator().manual_seed(317), device)
    loss_fn = mse_loss if task == "mse" else ce_loss
    # message_bias's gradient is zero in theory under a message bn1d:
    # both paths give float noise there, which is not compared
    params = [p for n, p in tnet.named_parameters()
              if not (n.endswith("message_bias")
                      and mc.msg_norm == "bn1d")]
    res = []
    for fused in (True, False):
        tnet.zero_grad(set_to_none=True)
        o, _ = network_apply_packed(tnet, tb, fused=fused,
                                    training=True)
        loss_fn(o, tb["labels"], tb["graph_mask"]).backward()
        res.append((o.detach(), [
            torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for p in params]))
    scale = float(res[1][0].abs().max()) or 1.0
    ok_o, err_o, _ = _within(res[0][0] / scale, res[1][0] / scale)
    _, _, ok_g, err_g = _fwd_bwd_errors(res[0], res[1])
    if not (ok_o and ok_g):
        raise RuntimeError(f"{what}: first step vs plain path, "
                           f"outputs {err_o:.2e}, gradients "
                           f"{err_g:.2e}")
    # device time of the model's kernels: one request, one train step
    step = eval_step_for_batch(cfg, task, next(iter(loader)))
    eb = batch_to_device(next(iter(loader)), device)
    for _ in range(2):
        step(tnet, eb)
        float(train_step(tnet, opt, tb, loss_kind=task))
    torch.cuda.synchronize()
    req_us = _kernel_device_us(_trace(lambda: step(tnet, eb)))
    step_us = _kernel_device_us(_trace(
        lambda: float(train_step(tnet, opt, tb, loss_kind=task))))
    train_counts = {k: counts[k] for k in want}
    return (
        f"{model} ({widths}, {nets} message networks, pf "
        f"{tnet.mpnn.message[0].shared.weight.shape[0]}): predict "
        f"{rows} molecules ({', '.join(serve_errs)} vs plain path), "
        f"launches {serve_counts}; train "
        f"{n_steps} steps, launches { {k: counts[k] for k in want} }, "
        f"first 3 losses vs plain max rel {rel:.2e}, first step's "
        f"outputs and {len(res[0][1])} gradients vs plain (scaled) "
        f"{err_o:.2e} / {err_g:.2e}; device us of one b16 request "
        + str({k: round(v, 2) for k, v in req_us.items()})
        + ", of one b16 train step "
        + str({k: round(v, 2) for k, v in step_us.items()}),
        serve_counts, train_counts)


def phase_wide(device, card):
    """lipo, basic, graph_norm, adv and att served and trained on the card
    at the widths of WIDE_SMILES (afm 27) through _verb_run: `predict` at
    batch 16, the `train` verb for one epoch at batch 16, launch counts,
    the plain path (predictions, first 3 losses, the first step's outputs
    and gradients) and each kernel's device time in a trace: every
    family's wide bucket and the chain kernels at these widths;
    basic_classification takes the shared family's od-128 bucket (od =
    4·afm = 108). Then lipo at f 33 raises."""
    import numpy as np
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch)
    os.makedirs(OUT_DIR, exist_ok=True)
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(
        WIDE_SMILES, [0.0] * len(WIDE_SMILES)))
    afm, bfm, nafm = ge.atom_width(), ge.bond_width(), gs[0].nafm.shape[1]
    if afm < 24:
        raise RuntimeError(f"wide: the SMILES featurize to afm {afm} < 24")
    lines = [f"afm {afm}, bfm {bfm}, nafm {nafm}"]
    step_counts = dict.fromkeys(STEP_KERNELS, 0)
    for model, (exp_name, kernels) in WIDE_MODELS.items():
        exp = experiments.get(exp_name)
        task = "mse" if model == "lipo" else "ce"
        cfg = (zoo.lipo(afm, bfm, nafm) if model == "lipo" else
               zoo.build(model, afm=afm, bfm=bfm, nafm=nafm,
                         n_out=PS_CLASSES))
        csv = _wide_csv(model, task, exp.label_col)
        line, sc, tc = _verb_run(
            f"wide {model}", model, exp, kernels, cfg, csv, WIDE_ROWS,
            task, PS_CLASSES, serve_bs=(16,),
            serving_net=model in ("lipo", "graph_norm"), device=device,
            files=f"wide_{model}")
        lines.append(line)
        for k in step_counts:
            step_counts[k] += sc.get(k, 0) + tc.get(k, 0)
    # lipo's wide backward (od = 2·afm: the f32 bucket) on every route, at
    # the widths its batch of 16 of these SMILES featurizes to
    gen = torch.Generator().manual_seed(44)
    tb = batch_to_device(_batch(WIDE_SMILES[:16], 16), device)
    f = tb["node_feats"].shape[1] + tb["node_nafm"].shape[1]
    od = 2 * tb["node_feats"].shape[1]
    line, _, bad = _bwd_route_checks(
        "wide lipo b16", _shell_args(tb, _random_weights(
            f, od, int(tb["edge_vfirst"].shape[0]), gen, device), True,
            gen), od, 6, "bn1d", "bn1d",
        ("cluster 1", "cluster 2", "cluster 4", "cluster 8", "grid",
         "spilled"), gen, device)
    lines.append(f"fused_step_bwd's routes: {line}")
    if bad:
        raise RuntimeError(f"wide: fused_step_bwd disagrees on {bad}")
    line, _, bad = _fwd_route_checks(
        "wide lipo b16", _shell_args(tb, _random_weights(
            f, od, int(tb["edge_vfirst"].shape[0]), gen, device), True,
            gen), od, 6, "bn1d", "bn1d", FWD_ROUTES, gen, device)
    lines.append(f"the forward kernels' routes: {line}")
    if bad:
        raise RuntimeError(f"wide: the forward kernels disagree on {bad}")
    # past the widest bucket: f 33 raises, naming the widths
    too_wide = zoo.lipo(afm + 3, bfm, nafm)
    net = network_init(too_wide, torch.Generator().manual_seed(5), device)
    b = next(iter(G.GraphLoader(gs, 8, collate="packed")))
    b["node_feats"] = np.pad(b["node_feats"], ((0, 0), (0, 3)))
    try:
        eval_step_for_batch(too_wide, "mse", b)(net,
                                                batch_to_device(b, device))
    except NotImplementedError as e:
        if "f=33" not in str(e):
            raise
        lines.append(f"lipo at f 33 raises NotImplementedError: {e}")
    else:
        raise RuntimeError("wide: lipo at f 33 did not raise")
    print(f"wide [{card}]: " + "; ".join(lines), flush=True)
    return step_counts


# ---------------------------------------------------------------------------
# the ECFP task: the bilinear family (ecfp_bilinear, row 17's kernels) and
# encoded_ecfp (the per-step kernels, obn, the 16,384-bit head): phases
# 25-29
# ---------------------------------------------------------------------------

BIL_KERNELS = ("fused_bilinear_fwd", "fused_bilinear_bwd")
# ecfp_bilinear's od is 32 whenever nbits > 64 (its zoo entry): the task
# is run at 32 bits, as the reference reaches the model
BIL_NBITS = 32


def _ecfp_csv(name, rows):
    """bench.py's molecules repeated to `rows`; the ECFP loader replaces
    the label column with each atom's Morgan bits."""
    os.makedirs(OUT_DIR, exist_ok=True)
    csv = os.path.join(OUT_DIR, f"{name}_{rows}.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n")
        for s in (SMILES * (rows // len(SMILES) + 1))[:rows]:
            fh.write(f"{s},0\n")
    return csv


def bil_cut(graphs, nf=2):
    """ecfp_bilinear's inputs as the reference reaches the model (through
    its Python API; mpnn_tpu's tests/test_fused_bilinear.py): node
    features cut to nf, bond rows zero-padded and cut to nf³ (8 at nf 2,
    the one coherent width). The port's tests take it from here."""
    import dataclasses
    import numpy as np
    out = []
    for g in graphs:
        ef = np.asarray(g.edge_feats, np.float32)
        ef = np.pad(ef, ((0, 0), (0, max(nf ** 3 - ef.shape[1], 0))))
        out.append(dataclasses.replace(
            g, afm=np.concatenate([g.afm, g.nafm], -1)[:, :nf],
            edge_feats=ef[:, :nf ** 3]))
    return out


def _bil_graphs(rows, nf=2):
    from mpnn_tpu_torch import graphs as G
    gs, _ = G.load_ecfp_dataset(_ecfp_csv("bil", rows), "smiles", "target",
                                nbits=BIL_NBITS)
    return bil_cut(gs, nf)


def _bil_net(seed, device):
    import torch
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    cfg = zoo.build("ecfp_bilinear", afm=2, bfm=8, n_out=BIL_NBITS)
    return cfg, network_init(cfg, torch.Generator().manual_seed(seed),
                             device)


def _bil_case(tb, gen, device, random_table):
    """fused_bilinear's arguments on a device batch: h0 its masked node
    features, the A table of its own bond rows (the main path's) or a
    random non-symmetric one (A_0 = 0), a random GRU; (args, leaves),
    h0 and the GRU leaves requiring grad."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    from mpnn_tpu_torch.models.fused_train import bilinear_table

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(device)
    mask = tb["node_mask"]
    f = int(tb["node_feats"].shape[1])
    k = int(tb["edge_vfirst"].shape[0])
    h0 = (tb["node_feats"] * mask).contiguous()
    if random_table:
        amat = r(k, f, f * f, s=0.5)
        amat[0] = 0.0
    else:
        amat = bilinear_table(tb, f)
    gru = {"w_ih": r(f, 3 * f, s=0.5), "w_hh": r(f, 3 * f, s=0.5),
           "b_ih": r(3 * f, s=0.1), "b_hh": r(3 * f, s=0.1)}
    leaves = [h0, *gru.values()]
    for t in leaves:
        t.requires_grad_()
    args = (amat, h0, mask, tb["node_graph"], gru, tb["edge_vid"],
            tb["edge_src"], tb["edge_dst"], plan_from_batch(tb))
    return args, leaves


def _bil_device_batch(graphs, bs, device, padded_slot=False):
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import attach_fused_plan
    from mpnn_tpu_torch.train.trainer import batch_to_device
    if not padded_slot:
        return batch_to_device(next(iter(G.GraphLoader(graphs, bs))), device)
    b = G.collate_packed(graphs, num_graphs=len(graphs) + 1).as_dict()
    b = attach_fused_plan(G.attach_edge_vocab(b, vocab_cap=16))
    return batch_to_device(b, device)


def phase_bil_kernel_check(device):
    """The two bilinear kernels against their plain versions on the card
    (rtol 1e-4, atol 1e-5; h0 and GRU gradients each divided by their max
    abs; each case also through the serving launch, which writes no
    message stash): ecfp_bilinear's main path at batch 1024 (f 2, T 2,
    the A table of its own bond rows), random non-symmetric tables at f
    2-4 and T 1-3 on the same molecules, and a ragged batch (single-atom
    molecules, padded edges, a padded graph slot)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    gen = torch.Generator().manual_seed(71)
    ragged = SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
    from mpnn_tpu_torch import graphs as G
    raw, _ = G.encode_molgraphs(G.generate_molgraphs(
        (SMILES * 103)[:1024], [0] * 1024))
    rg, _ = G.encode_molgraphs(G.generate_molgraphs(ragged, [0] * 12))
    cases = [("batch1024 f2 T2 (its own table)", 1024, 2, 2, False, False),
             ("batch1024 f2 T1", 1024, 2, 1, True, False),
             ("batch1024 f3 T3", 1024, 3, 3, True, False),
             ("batch1024 f4 T2", 1024, 4, 2, True, False),
             ("ragged f2 T3", 12, 2, 3, True, True),
             ("ragged f4 T1", 12, 4, 1, True, True)]
    worst = dict.fromkeys(BIL_KERNELS, 0.0)
    results, failed = [], []
    for what, bs, f, steps, rand, pad in cases:
        tb = _bil_device_batch(bil_cut(rg if pad else raw, f), bs, device,
                               padded_slot=pad)
        args, leaves = _bil_case(tb, gen, device, rand)
        cw = torch.randn(args[1].shape[0], steps * f,
                         generator=gen).to(device)
        kw = dict(steps=steps)
        got = _fwd_and_grads(B.fused_bilinear, args, leaves, cw, kw)
        torch.cuda.synchronize()
        want = _fwd_and_grads(B.fused_bilinear_reference, args, leaves, cw,
                              kw)
        ok_f, ef, ok_b, eb = _fwd_bwd_errors(got, want)
        with torch.no_grad():
            served = B.fused_bilinear(*args, **kw)
        torch.cuda.synchronize()
        ok_s, es, _ = _within(served, want[0])
        worst["fused_bilinear_fwd"] = max(worst["fused_bilinear_fwd"], ef,
                                          es)
        worst["fused_bilinear_bwd"] = max(worst["fused_bilinear_bwd"], eb)
        ok = ok_f and ok_b and ok_s
        n, g = int(tb["node_mask"].shape[0]), int(tb["graph_mask"].shape[0])
        results.append(
            f"{what} (nodes {int(tb['node_mask'].sum())}/{n} slots, G={g}, "
            f"edges {int(tb['edge_mask'].sum())}/{tb['edge_src'].shape[0]}, "
            f"vocab {args[0].shape[0]}): fwd {ef:.2e} (serving {es:.2e}) "
            f"bwd {eb:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)
    print("bil-kernel-check: fused_bilinear_fwd/bwd vs "
          "fused_bilinear_reference and autograd through it (cotangent "
          f"Σ hist·c; forward max abs error, rtol {RTOL} atol {ATOL}; "
          "gradient leaves divided by their max abs, max error, rtol "
          f"{RTOL} atol {ATOL}): " + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"bilinear kernels disagree with their plain "
                           f"versions: {failed}")
    return worst


def phase_bil_serve(device):
    """ecfp_bilinear served through the port's API (train/cli.py::
    predict_batches, the eval step a user's `predict` runs) at batch 128
    and 1024 with seeded weights: exactly one fused_bilinear_fwd launch
    per request, no backward; outputs against the plain path on the card,
    batch by batch. Returns the launch counts."""
    import numpy as np
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    from mpnn_tpu_torch.models.network import network_apply_packed
    from mpnn_tpu_torch.train.cli import predict_batches
    from mpnn_tpu_torch.train.trainer import batch_to_device
    cfg, net = _bil_net(73, device)
    totals, lines = dict.fromkeys(BIL_KERNELS, 0), []
    for bs, rows in ((128, 384), (1024, 2048)):
        gs = _bil_graphs(rows)
        loader = G.GraphLoader(gs, bs)
        B.reset_launch_counts()
        t0 = time.perf_counter()
        out = torch.tensor(np.concatenate(
            list(predict_batches(net, "ecfp_mse", loader, device))),
            dtype=torch.float64)
        wall = time.perf_counter() - t0
        counts = dict(B.launch_counts)
        n_req = -(-rows // bs)
        want = {"fused_bilinear_fwd": n_req, "fused_bilinear_bwd": 0}
        if counts != want:
            raise RuntimeError(f"ecfp_bilinear serve at batch {bs}: "
                               f"launches {counts}, the design's count is "
                               f"{want}")
        for k in totals:
            totals[k] += counts[k]
        with torch.no_grad():
            plain = torch.cat([
                network_apply_packed(net, batch_to_device(b, device),
                                     fused=False).cpu()
                for b in loader]).to(torch.float64)
        ok, mabs, mrel = _within(out, plain)
        ok = ok and bool(torch.isfinite(out).all()) \
            and out.shape == (rows, BIL_NBITS)
        lines.append(f"batch {bs}: {rows} molecules in {n_req} requests, "
                     f"{counts['fused_bilinear_fwd']} forward launches, "
                     f"{wall:.2f} s wall (collate+serve), outputs vs plain "
                     f"path max_abs={mabs:.3e} max_rel={mrel:.3e} "
                     f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"ecfp_bilinear batch {bs}: served outputs "
                               f"disagree with the plain path ({mabs:.3e})")
    print("bil-serve: ecfp_bilinear (nf 2, ef 8, T 2, od 32, head none; "
          f"ECFP labels at {BIL_NBITS} bits); " + "; ".join(lines),
          flush=True)
    return totals


def phase_bil_train(device):
    """ecfp_bilinear trained through train/trainer.py::train (ecfp_mse,
    Adam lr 1e-3 / wd 1e-5, 2 epochs at batch 128 on 640 molecules, a
    validation split): one forward and one backward launch per step, one
    forward per validation batch; the first 3 losses against the plain
    path on the card (rtol 1e-3); finite losses. Returns the launch
    counts."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import (TrainConfig, batch_to_device,
                                              train, train_step)
    gs = _bil_graphs(TRAIN_ROWS)
    train_gs, val_gs = train_test_split(gs, 0.1, 317)
    cfg, _ = _bil_net(0, "cpu")
    log = os.path.join(OUT_DIR, "train_ecfp_bilinear.jsonl")
    if os.path.exists(log):
        os.remove(log)
    tcfg = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=128,
                       learning_rate=1e-3, weight_decay=1e-5,
                       loss="ecfp_mse", seed=317, log_path=log)
    B.reset_launch_counts()
    t0 = time.perf_counter()
    _, hist = train(cfg, tcfg, train_gs, val_gs, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(B.launch_counts)
    with open(log) as fh:
        steps = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    per_epoch = -(-len(train_gs) // 128)
    want = {"fused_bilinear_fwd": TRAIN_EPOCHS * (
        per_epoch + -(-len(val_gs) // 128)),
        "fused_bilinear_bwd": TRAIN_EPOCHS * per_epoch}
    if len(steps) != TRAIN_EPOCHS * per_epoch or counts != want:
        raise RuntimeError(f"ecfp_bilinear train: {len(steps)} steps, "
                           f"launches {counts}; the design's count is "
                           f"{want}")
    if not (all(math.isfinite(x) for x in steps)
            and all(math.isfinite(r["val_loss"]) for r in hist)):
        raise RuntimeError("ecfp_bilinear train: non-finite loss")
    net = network_init(cfg, torch.Generator().manual_seed(317), device)
    opt = adam(net.parameters(), 1e-3, weight_decay=1e-5)
    plain = []
    for b in G.GraphLoader(train_gs, 128, shuffle=True, seed=317):
        if len(plain) == 3:
            break
        plain.append(float(train_step(net, opt, batch_to_device(b, device),
                                      fused=False, loss_kind="ecfp_mse")))
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if rel > 1e-3:
        raise RuntimeError(f"ecfp_bilinear train: first steps {steps[:3]} "
                           f"vs plain path {plain} (rel {rel:.2e})")
    print(f"bil-train: ecfp_bilinear, {TRAIN_ROWS} molecules (train "
          f"{len(train_gs)}, val {len(val_gs)}), batch 128, {TRAIN_EPOCHS} "
          f"epochs, {len(steps)} steps in {wall:.2f} s wall; launches fwd "
          f"{counts['fused_bilinear_fwd']}, bwd "
          f"{counts['fused_bilinear_bwd']} (design: 1 + 1 per step, 1 per "
          f"validation batch); step losses first {steps[0]:.5f} last "
          f"{steps[-1]:.5f}; val loss "
          f"{[round(r['val_loss'], 5) for r in hist]}; first 3 steps vs "
          f"plain path max rel {rel:.2e}", flush=True)
    return counts


def _bil_bounds(b, f, k, T):
    """Least times of the two bilinear kernels' work on this batch, each
    the larger of its float32 operations over the peak CUDA-core rate and
    its bytes (each input read once, each output written once; the
    forward as serving runs it, with no message stash; the backward reads
    the stash) over HBM bandwidth. Real nodes and edges; a transcendental
    counts as one operation. The function's inputs, not the kernels': the
    edges as vid, src and dst and the node mask, not the index plan the
    wrapper builds from them (edge and source orders, their pointers, the
    graphs' node ranges)."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    gemv = 2 * f * 3 * f                           # f → 3f gate GEMV
    weights = k * f ** 3 + 6 * f * f + 6 * f
    idx = er * 3 + nr                              # vid, src, dst, mask
    # per step: per edge φ (f²) and A·φ (2f³); per node the input gates
    # and the blend (~15f); the hidden gates once per node
    fwd = (T * (er * (f * f + 2 * f ** 3) + nr * (gemv + 15 * f))
           + nr * gemv,
           4 * (nr * f + idx + weights + nr * T * f))
    # per step and node: the input gates recomputed from the stashed
    # message, the gate VJP (~30f), the transposed GEMVs into dmsg and dh0
    # and the outer products into W_ih's and W_hh's rows (1 + 2 + 2
    # GEMV-sized); the hidden gates once per node, as they do not change
    # between steps; per step and edge: dφ = Aᵀ·dmsg (2f³) once and its
    # contractions with either end's state (2f² each)
    bwd = (T * (nr * (5 * gemv + 30 * f) + er * (2 * f ** 3 + 4 * f * f))
           + nr * gemv,
           4 * (nr * f + 3 * nr * T * f + idx + weights + nr * f
                + 6 * f * f + 6 * f))
    out = {}
    for name, (ops, nbytes) in zip(BIL_KERNELS, (fwd, bwd)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def phase_bil_times(device, card):
    """ecfp_bilinear at batch 128 and 1024: request and train-step
    latency (host clock ending in a device sync, medians of 20), the two
    kernels' times (CUDA events over repeated launches on the main path's
    inputs; the forward as serving runs it, and with the training stash)
    beside their bounds and their plain versions' times."""
    import statistics
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models.fused_train import bilinear_table
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch,
                                              train_step)
    out, lines = {}, []
    gen = torch.Generator().manual_seed(79)
    for bs in (128, 1024):
        b = next(iter(G.GraphLoader(_bil_graphs(bs), bs)))
        tb = batch_to_device(b, device)
        cfg, net = _bil_net(79, device)
        opt = adam(net.parameters(), 1e-3, weight_decay=1e-5)
        estep = eval_step_for_batch(cfg, "ecfp_mse", b)

        def request():
            _, o = estep(net, batch_to_device(b, device))
            o.cpu()
            torch.cuda.synchronize()

        def step():
            float(train_step(net, opt, tb, loss_kind="ecfp_mse"))
            torch.cuda.synchronize()
        rec = {}
        for name, fn in (("request_ms", request), ("step_ms", step)):
            for _ in range(3):
                fn()
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                fn()
                lat.append((time.perf_counter() - t0) * 1e3)
            rec[name] = statistics.median(lat)
        c = cfg.mpnn
        f, T = c.node_features, c.message_steps
        mask, ng = tb["node_mask"], tb["node_graph"]
        batch = (tb["edge_vid"], tb["edge_src"], tb["edge_dst"],
                 plan_from_batch(tb))
        with torch.no_grad():
            h0 = (tb["node_feats"] * mask).contiguous()
            amat = bilinear_table(tb, f)
            gru = {k: v.detach() for k, v in net.mpnn.gru.as_dict().items()}
            pe = B.prepare_fused_bilinear_fwd(amat, h0, mask, ng, gru,
                                              *batch, steps=T,
                                              write_msgs=False)
            pt = B.prepare_fused_bilinear_fwd(amat, h0, mask, ng, gru,
                                              *batch, steps=T,
                                              write_msgs=True)
            times = {"fused_bilinear_fwd": _events_ms(
                lambda: K.launch_prepared(pe), 200)}
            t_train = _events_ms(lambda: K.launch_prepared(pt), 200)
            plain = {"fused_bilinear_fwd": _events_ms(
                lambda: B.fused_bilinear_reference(amat, h0, mask, ng, gru,
                                                   *batch, steps=T), 20)}
            hist, msgs = K.launch_prepared(pt)
            gh = torch.randn(hist.shape, generator=gen).to(device)
            pb = B.prepare_fused_bilinear_bwd(amat, h0, gru, hist, msgs, gh,
                                              *batch, steps=T,
                                              max_nodes=pt.args[-2])
            times["fused_bilinear_bwd"] = _events_ms(
                lambda: K.launch_prepared(pb), 200)
        leaves = [h0.clone().requires_grad_()] + [
            t.clone().requires_grad_() for t in gru.values()]
        h_ref = B.fused_bilinear_reference(
            amat, leaves[0], mask, ng, dict(zip(gru, leaves[1:])), *batch,
            steps=T)
        obj = (h_ref * gh).sum()
        plain["fused_bilinear_bwd"] = _events_ms(lambda: torch.autograd.grad(
            obj, leaves, retain_graph=True), 10)
        bounds = _bil_bounds(b, f, amat.shape[0], T)
        for name in BIL_KERNELS:
            rec[name] = dict(ms=times[name], plain_ms=plain[name],
                             bound_ms=bounds[name][0],
                             bound_by=bounds[name][1])
        out[bs] = rec
        lines.append(
            f"ecfp_bilinear batch {bs} (nodes {int(b['node_mask'].sum())}/"
            f"{b['node_mask'].shape[0]}, edges {int(b['edge_mask'].sum())}/"
            f"{b['edge_src'].shape[0]}, vocab {amat.shape[0]}, T {T}): "
            f"request median {rec['request_ms']:.3f} ms, train step median "
            f"{rec['step_ms']:.3f} ms (20 reps each); " + ", ".join(
                f"{name} {times[name] * 1e3:.2f} us (events"
                + (f"; with the message stash {t_train * 1e3:.2f} us"
                   if name == "fused_bilinear_fwd" else "")
                + f"), plain {plain[name] * 1e3:.1f} us, bound "
                f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.3f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in BIL_KERNELS))
    print(f"bil-times [{card}]: " + "; ".join(lines), flush=True)
    return out


ECFP_ROWS = 1024


def _ecfp_latency(net, b, tb, device):
    """encoded_ecfp on one collated batch: the request (host batch →
    predictions, collation excluded) and train-step (device batch → loss
    read back, Adam on a copy of `net`) latency, medians of 5 after 2
    warm-ups, and one profiled train step's device busy time and idle
    share."""
    import copy
    import statistics
    import torch
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (batch_to_device,
                                              eval_step_for_batch,
                                              train_step)
    estep = eval_step_for_batch(net.cfg, "ecfp_mse", b)
    tnet = copy.deepcopy(net)
    opt = adam(tnet.parameters(), 1e-3, weight_decay=1e-5)

    def request():
        _, o = estep(net, batch_to_device(b, device))
        o.cpu()
        torch.cuda.synchronize()

    def step():
        float(train_step(tnet, opt, tb, loss_kind="ecfp_mse"))
        torch.cuda.synchronize()
    rec = {}
    for name, fn in (("request", request), ("step", step)):
        for _ in range(2):
            fn()
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            lat.append((time.perf_counter() - t0) * 1e3)
        rec[name] = statistics.median(lat)
    prof = _trace(step)
    busy, ops = _device_ops(prof)
    g = int(b["graph_mask"].shape[0])
    with open(os.path.join(OUT_DIR, f"profile_encoded_ecfp_train_{g}.txt"),
              "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    return (f"request median {rec['request']:.2f} ms (host batch → "
            f"predictions), train step median {rec['step']:.2f} ms (5 reps "
            f"each); one train step's device busy {busy:.1f} us in "
            f"{sum(e.count for e in ops)} device ops, idle share "
            f"{1 - busy / (rec['step'] * 1e3):.3f}")


def phase_ecfp(device, card):
    """encoded_ecfp, the reference's ECFP script, through the verbs a user
    runs, at the reference's 16,384 bits and radius 3 on its own SMILES
    CSV: `predict` at batch 128 and 1024 from a seeded checkpoint (one
    per-step eval launch per request, three edge-MLP forwards each; the
    first logit of each molecule against the plain path on the card,
    whose output norm obn follows the readout), then `train` (the
    experiment's batch 128, 2 epochs: one per-step forward and backward
    launch per step, one eval launch per validation and test batch; the
    first 3 losses against the plain path, rtol 1e-3; obn's running
    statistics moved in the checkpoint it writes). Reports, at batch 128
    and 1024, the host collation and the host-to-device copy of a batch,
    whose float32 node_labels dominate both, the request latency (host
    batch → predictions) and the train-step latency (device batch → loss
    read back), and one profiled train step's device busy time. Returns
    the per-step kernels' launches."""
    import statistics
    import numpy as np
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train import cli
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    csv = _ecfp_csv("ecfp", ECFP_ROWS)
    t0 = time.perf_counter()
    gs, ge = G.load_ecfp_dataset(csv, "smiles", "target")
    load_s = time.perf_counter() - t0
    cfg = zoo.build("encoded_ecfp", afm=ge.atom_width(), bfm=ge.bond_width(),
                    n_out=16384)
    nets = _nets(cfg.mpnn)
    net = network_init(cfg, torch.Generator().manual_seed(83), "cpu")
    ckpt = os.path.join(OUT_DIR, "ckpt_encoded_ecfp.npz")
    save_checkpoint(ckpt, net, meta={"seed": 83, "model": "encoded_ecfp"})
    pnet, _ = load_checkpoint(ckpt, cfg, device=device)
    totals, lines = dict.fromkeys(PS_KERNELS, 0), []
    for bs in (128, 1024):
        loader = G.GraphLoader(gs, bs)
        chunk = loader._epoch_chunks()[0]
        col, h2d = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            b = loader._collate_chunk(chunk)
            col.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb = batch_to_device(b, device)
            torch.cuda.synchronize()
            h2d.append((time.perf_counter() - t0) * 1e3)
        mb = b["node_labels"].nbytes / 1e6
        lat = _ecfp_latency(pnet, b, tb, device)
        del tb
        buf = io.StringIO()
        P.reset_launch_counts()
        _mlp_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", "--experiment", "encoded_ecfp", "--data",
                      csv, "--ckpt", ckpt, "--batch-size", str(bs)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_req = -(-ECFP_ROWS // bs)
        counts = dict(P.launch_counts)
        _mlp_take(f"encoded_ecfp predict at batch {bs}", nets,
                  counts["fused_psteps_eval"], 0)
        if counts != {"fused_psteps_eval": n_req, "fused_psteps_fwd": 0,
                      "fused_psteps_bwd": 0}:
            raise RuntimeError(f"encoded_ecfp predict at batch {bs}: "
                               f"launches {counts} for {n_req} requests")
        totals["fused_psteps_eval"] += n_req
        recs = [json.loads(x) for x in buf.getvalue().splitlines() if x]
        if [r["index"] for r in recs] != list(range(ECFP_ROWS)):
            raise RuntimeError(f"encoded_ecfp predict at batch {bs}: "
                               f"{len(recs)} records for {ECFP_ROWS}")
        got = torch.tensor([r["pred"] for r in recs], dtype=torch.float64)
        with torch.no_grad():
            plain = torch.cat([
                network_apply_packed(pnet, batch_to_device(bb, device),
                                     fused=False)[:, 0].cpu()
                for bb in loader]).to(torch.float64)
        ok, mabs, mrel = _within(got, plain)
        ok = ok and bool(torch.isfinite(got).all())
        lines.append(
            f"predict batch {bs}: {ECFP_ROWS} molecules in {n_req} "
            f"requests, {n_req} fused_psteps_eval launches, {wall:.2f} s "
            f"wall (featurize+ECFP+load+serve); first logits vs plain path "
            f"(obn after the readout) max_abs={mabs:.3e} max_rel={mrel:.3e} "
            f"{'ok' if ok else 'FAIL'}; host collation median "
            f"{statistics.median(col):.1f} ms, host-to-device median "
            f"{statistics.median(h2d):.1f} ms (node_labels {mb:.1f} MB "
            f"float32 of {b['node_mask'].shape[0]} node slots); {lat}")
        if not ok:
            raise RuntimeError(f"encoded_ecfp batch {bs}: served logits "
                               f"disagree with the plain path ({mabs:.3e})")
    log = os.path.join(OUT_DIR, "train_encoded_ecfp.jsonl")
    ckdir = os.path.join(OUT_DIR, "train_ckpt_encoded_ecfp")
    if os.path.exists(log):
        os.remove(log)
    buf = io.StringIO()
    P.reset_launch_counts()
    _mlp_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["train", "--experiment", "encoded_ecfp", "--data", csv,
                  "--epochs", str(TRAIN_EPOCHS), "--ckpt-dir", ckdir,
                  "--log", log])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(P.launch_counts)
    _mlp_take("encoded_ecfp train", nets,
              counts["fused_psteps_fwd"] + counts["fused_psteps_eval"],
              counts["fused_psteps_bwd"])
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(log) as fh:
        steps = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    train_gs, test_gs = train_test_split(gs, 0.1, 317)
    train_gs, val_gs = train_test_split(train_gs, 0.1, 317)
    per_epoch = -(-len(train_gs) // 128)
    want = {"fused_psteps_fwd": TRAIN_EPOCHS * per_epoch,
            "fused_psteps_bwd": TRAIN_EPOCHS * per_epoch,
            "fused_psteps_eval": TRAIN_EPOCHS * -(-len(val_gs) // 128)
            + -(-len(test_gs) // 128)}
    if len(steps) != want["fused_psteps_fwd"] or counts != want:
        raise RuntimeError(f"encoded_ecfp train: {len(steps)} steps, "
                           f"launches {counts}; the design's count is "
                           f"{want}")
    if not (all(math.isfinite(x) for x in steps)
            and math.isfinite(result["test"]["loss"])):
        raise RuntimeError("encoded_ecfp train: non-finite loss")
    for k in PS_KERNELS:
        totals[k] += counts[k]
    net = network_init(cfg, torch.Generator().manual_seed(317), device)
    opt = adam(net.parameters(), 1e-3, weight_decay=1e-5)
    plain = []
    for bb in G.GraphLoader(train_gs, 128, shuffle=True, seed=317):
        if len(plain) == 3:
            break
        plain.append(float(train_step(net, opt, batch_to_device(bb, device),
                                      fused=False, loss_kind="ecfp_mse")))
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if rel > 1e-3:
        raise RuntimeError(f"encoded_ecfp train: first steps {steps[:3]} vs "
                           f"plain path {plain} (rel {rel:.2e})")
    last = os.path.join(ckdir, f"ckpt_{TRAIN_EPOCHS - 1}.npz")
    with np.load(last) as z:
        obn_mean = z["state/mpnn/obn/running_mean"]
        obn_var = z["state/mpnn/obn/running_var"]
    if not (obn_mean.any() and (obn_var != 1).any()):
        raise RuntimeError("encoded_ecfp train: obn's running statistics "
                           "did not move")
    lines.append(
        f"train: {ECFP_ROWS} molecules (train {len(train_gs)}, val "
        f"{len(val_gs)}, test {len(test_gs)}), batch 128, {TRAIN_EPOCHS} "
        f"epochs, {len(steps)} steps in {wall:.2f} s wall; launches fwd "
        f"{counts['fused_psteps_fwd']}, bwd {counts['fused_psteps_bwd']}, "
        f"eval {counts['fused_psteps_eval']} (design: 1 + 1 per step, 1 per "
        f"eval batch); step losses first {steps[0]:.5f} last "
        f"{steps[-1]:.5f}, test loss {result['test']['loss']:.5f}; first 3 "
        f"steps vs plain path max rel {rel:.2e}; obn running mean "
        f"|max| {float(abs(obn_mean).max()):.3e} after training")
    print(f"ecfp [{card}]: encoded_ecfp at 16384 bits, radius 3 "
          f"({ECFP_ROWS} molecules featurized with their bits in "
          f"{load_s:.2f} s); " + "; ".join(lines), flush=True)
    return totals


# ---------------------------------------------------------------------------
# the decomposed training path (lipo, the per-step family): phases 30-33
# ---------------------------------------------------------------------------

DEC_KERNELS = ("spmm_fwd", "spmm_da", "recurrence_fwd", "recurrence_bwd")
# the new kernels' launches on the main paths (dec-train), summed
DEC_MAIN = dict.fromkeys(DEC_KERNELS, 0)
DEC_STEPS = 6
# rec-kernel-check's node slots besides b16's: b1024's and 2,560 molecules'
REC_NODES = (16512, 32896)
# and the split's (lipo b3584), past the forward's tiles at f 30
REC_SPLIT_NODES = 57856
# dec-times' batch sizes; the kernels are timed at the last
DEC_TIMES_BATCHES = (16, 1024)


def _kernel_modules():
    import importlib
    return [importlib.import_module(f"mpnn_tpu_torch.kernels.{m}")
            for m in ("fused_step", "fused_psteps", "fused_att",
                      "fused_att_steps", "set2vec", "edge_mlp",
                      "fused_bilinear", "spmm", "recurrence", "sddmm",
                      "readout_bwd", "msg_bwd", "psteps_walk")]


def _dec_reset():
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def _launch_counts():
    """Every kernel wrapper's launch count, by kernel."""
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.launch_counts)
    return counts


def _dec_take(what, want):
    """Check the launches since _dec_reset() against the design's `want`:
    every kernel it names as it says, every other kernel of the port
    unlaunched; add the main path's to DEC_MAIN, DEC_ATT_MAIN and
    MLP_MAIN; return them."""
    counts = _launch_counts()
    got = {k: counts[k] for k in want}
    other = {k: v for k, v in counts.items() if k not in want and v}
    if other:
        raise RuntimeError(f"{what}: other kernels launched {other}")
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, the design's count is "
                           f"{want}")
    for main in (DEC_MAIN, DEC_ATT_MAIN, MLP_MAIN):
        for k in main:
            main[k] += got.get(k, 0)
    return got


def _spmm_case(tb, f, k, gen, device):
    """(a, h, vid, src, dst, plan, g) on a device batch: h random on the
    real rows and zero on the padded ones, a random table with A_0 = 0 and
    a cotangent g. k None: the batch's own vocabulary (its edge_vid, K its
    vocab capacity); else k ids drawn at random for the real edges, the
    padded edges keeping id 0; k 1: every edge id 0, A_0 random."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    mask = tb["node_mask"]
    n = mask.shape[0]
    vid = tb["edge_vid"]
    if k is None:
        k = int(tb["edge_vfirst"].shape[0])
    elif k == 1:
        vid = torch.zeros_like(vid)
    else:
        rnd = torch.randint(1, k, vid.shape, generator=gen,
                            dtype=torch.int32).to(device)
        vid = torch.where(tb["edge_mask"] > 0, rnd,
                          torch.zeros_like(rnd)).contiguous()
    a = 0.3 * torch.randn(k, f, f, generator=gen)
    if k > 1:
        a[0] = 0.0
    h = (torch.randn(n, f, generator=gen).to(device) * mask).contiguous()
    g = torch.randn(n, f, generator=gen).to(device)
    return (a.to(device), h, vid, tb["edge_src"], tb["edge_dst"],
            plan_from_batch(tb), g)


@contextlib.contextmanager
def _spmm_route(per=None):
    """Force spmm_fwd's tiles (kernels/spmm.py::launch_shape) inside the
    block: `per`, the positions a lane group takes in a tile (1: the
    smallest tiles, every long row crossing many of them). A
    measurement's and a check's; the wrapper takes the rule's."""
    import torch
    from mpnn_tpu_torch.kernels import spmm as S
    real = S.device_shape

    def forced(n_pos, mo, ni, k_vocab, device):
        props = torch.cuda.get_device_properties(device)
        return S.launch_shape(
            n_pos, mo, ni, k_vocab,
            smem_bytes=props.shared_memory_per_block_optin,
            sms=props.multi_processor_count, per=per)
    S.device_shape = forced
    try:
        yield
    finally:
        S.device_shape = real


# spmm-kernel-check's tiles: (name, _spmm_route's arguments); in "small
# tiles" a lane group takes one position, so the dummy row and a hub's
# cross many tiles
SPMM_ROUTES = {"rule": {}, "small tiles": dict(per=1)}


def spmm_hub_case(c, hub, gen):
    """An SpMM case (a, h, vid, src, dst, plan, g) with `hub` of its real
    edges (those not ending at the dummy last node) turned to end at one
    real node, a destination of high in-degree whose row crosses tiles,
    and the index plan rebuilt for it."""
    import numpy as np
    import torch
    from mpnn_tpu_torch.graphs.batching import FusedEvalPlan, plan_fused_eval
    a, h, vid, src, dst, plan, g = c
    n = h.shape[0]
    d = dst.cpu().numpy().copy()
    real = np.nonzero(d != n - 1)[0]
    pick = torch.randperm(len(real), generator=gen)[:hub].numpy()
    d[real[pick]] = d[real[len(real) // 2]]
    # the plan's graph pointers are the batch's: node_graph from them
    gp = plan.graph_node_ptr.cpu().numpy()
    ng = np.full(n, len(gp) - 1, np.int32)
    for i in range(len(gp) - 1):
        ng[gp[i]:gp[i + 1]] = i
    new = FusedEvalPlan(*(torch.as_tensor(x, device=dst.device)
                          for x in plan_fused_eval(d, ng, len(gp) - 1)))
    return a, h, vid, src, torch.as_tensor(d, device=dst.device), new, g


def spmm_value_and_grads(fn, a, h, vid, src, dst, plan, g):
    """(out, dA, dh) of the SpMM op `fn` for the cotangent g of out."""
    import torch
    a, h = a.detach().requires_grad_(), h.detach().requires_grad_()
    out = fn(a, h, vid, src, dst, plan)
    da, dh = torch.autograd.grad((out * g).sum(), [a, h])
    return out.detach(), da, dh


def sddmm_value_and_grads(fn, aprime, evocab, wa, ba, h, vid, src, dst,
                          plan, g):
    """(out, d aprime, d evocab, d wa, d ba, dh) of the SDDMM op `fn` for
    the cotangent g of out."""
    import torch
    leaves = [x.detach().requires_grad_() for x in (aprime, evocab, wa, ba,
                                                    h)]
    out = fn(*leaves, vid, src, dst, plan)
    return (out.detach(), *torch.autograd.grad((out * g).sum(), leaves))


def _scaled_within(got, want):
    """_within of got and want each divided by want's max abs."""
    scale = want.abs().max().clamp_min(1e-30)
    return _within(got / scale, want / scale)


@functools.lru_cache(maxsize=None)
def _dec_check_batches(device):
    """The device batches of the decomposed kernels' checks (spmm- and
    sddmm-kernel-check), built once: b1024 at the 16,512 node slots the
    serving path gives it (past the 16,384 where the JAX package changes
    its layouts), b16, 2,560 molecules in 32,896 slots, and the ragged
    batch."""
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import attach_fused_plan
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gs, _ = G.encode_molgraphs(G.generate_molgraphs(
        (SMILES * 103)[:1024], [0.0] * 1024))
    b1024 = batch_to_device(attach_fused_plan(G.attach_edge_vocab(
        G.collate_packed(gs, node_cap=16512).as_dict(), vocab_cap=8)),
        device)
    return (b1024, batch_to_device(_batch(SMILES * 2, 16), device),
            batch_to_device(_batch((SMILES * 256)[:2560], 2560), device),
            _ragged_att_batch(device))


def phase_spmm_kernel_check(device):
    """spmm_fwd (the forward, and its transposed launch: the VJP's dh) and
    spmm_da against the plain version under autograd on the card: lipo's
    b1024 batch in 16,512 node slots at bench widths (f 10, its own
    vocab), f 30 with 64 random vocab ids (the wide bucket), K 1 and 64 in
    the narrow bucket and K 8 in the wide one, a ragged batch (single
    atoms, padded edges, a padded graph slot), b16, and 32,896 node slots;
    on the rule's tiles and the smallest (SPMM_ROUTES: the dummy row then
    spans hundreds of tiles), and a hub node of 400 edges on both. Each
    case twice, the same bits. out within rtol 1e-4 / atol 1e-5; dA and
    dh each divided by its max abs."""
    import torch
    from mpnn_tpu_torch.kernels import spmm as S
    gen = torch.Generator().manual_seed(81)
    b1024, b16, big, ragged = _dec_check_batches(device)
    cases = [("batch1024", b1024, 10, None, "rule", 0),
             ("batch1024", b1024, 10, None, "small tiles", 0),
             ("batch1024", b1024, 30, 64, "rule", 0),
             ("batch1024", b1024, 10, 1, "rule", 0),
             ("batch1024", b1024, 10, 64, "rule", 0),
             ("batch1024", b1024, 30, 8, "small tiles", 0),
             ("batch1024 hub", b1024, 10, None, "rule", 400),
             ("batch1024 hub", b1024, 10, None, "small tiles", 400),
             ("ragged", ragged, 10, None, "rule", 0),
             ("ragged", ragged, 30, 64, "small tiles", 0),
             ("batch16", b16, 10, None, "rule", 0),
             ("batch2560", big, 10, None, "rule", 0),
             ("batch2560", big, 30, 64, "small tiles", 0)]
    worst = {"spmm_fwd": 0.0, "spmm_da": 0.0}
    results, failed = [], []
    for what, tb, f, k, route, hub in cases:
        c = _spmm_case(tb, f, k, gen, device)
        if hub:
            c = spmm_hub_case(c, hub, gen)
        S.reset_launch_counts()
        with _spmm_route(**SPMM_ROUTES[route]):
            got = spmm_value_and_grads(S.spmm, *c)
            again = spmm_value_and_grads(S.spmm, *c)
            torch.cuda.synchronize()
            shape = S.device_shape(c[2].shape[0], f, f, c[0].shape[0],
                                   device)
        counts = dict(S.launch_counts)
        want = spmm_value_and_grads(
            lambda *x: S.spmm_reference(*x[:5]), *c)
        ok_o, err_o, _ = _within(got[0], want[0])
        ok_a, err_a, _ = _scaled_within(got[1], want[1])
        ok_h, err_h, _ = _scaled_within(got[2], want[2])
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        # the padded edges sit on the dummy (last) node: exactly zero there
        # (dh too where A_0 = 0: every K but 1)
        pad0 = not got[0][-1].any() and (k == 1 or not got[2][-1].any())
        ok = (ok_o and ok_a and ok_h and pad0 and same and counts == {
            "spmm_fwd": 4, "spmm_da": 2}
            and all(bool(torch.isfinite(x).all()) for x in got))
        worst["spmm_fwd"] = max(worst["spmm_fwd"], err_o, err_h)
        worst["spmm_da"] = max(worst["spmm_da"], err_a)
        results.append(
            f"{what} f={f} K={c[0].shape[0]} {route} {shape.tag()} (nodes "
            f"{int(tb['node_mask'].sum())}/{tb['node_mask'].shape[0]} "
            f"slots, edges {int(tb['edge_mask'].sum())}/"
            f"{tb['edge_src'].shape[0]}): out max_abs={err_o:.3e} dh "
            f"max_scaled={err_h:.3e} dA max_scaled={err_a:.3e}"
            f"{'' if same else ' BITS DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{what} f={f} {route}: {counts}, padded rows "
                          f"zero {pad0}")
    print(f"spmm-kernel-check: spmm_fwd (forward and dh) and spmm_da vs "
          f"spmm_reference under autograd (rtol {RTOL} atol {ATOL}; dA, dh "
          f"divided by their max abs; 2 + 1 launches a run, two runs a "
          f"case for the same bits): " + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"the SpMM kernels disagree with their plain "
                           f"version: {failed}")
    return worst


def rec_case(n, f, gen, device, weight_sd=None):
    """The recurrence's arguments at n node slots: messages off-centre (a
    feature mean of 0.5 to 2, so the variance is taken around a mean far
    from 0), h0, a random 0/1 mask (a quarter of the rows off), the GRU
    weights at the model's init scale (xavier-uniform, ops/update.py; or
    N(0, weight_sd²)) with random biases, and non-trivial norm affines,
    all leaves requiring grad; returns (args, leaves, cotangent of h_T),
    args = (msgs, h0, mask, gru, ma_bn, bn). Past the init scale six
    steps amplify float32 rounding: rec-kernel-check holds the kernels
    and the plain chain against a float64 run at N(0, 0.3²)."""
    import torch

    def r(*shape, sc=1.0):
        return (sc * torch.randn(*shape, generator=gen)).to(device)

    def xavier(*shape):
        if weight_sd is not None:
            return r(*shape, sc=weight_sd)
        lim = math.sqrt(6.0 / (shape[0] + shape[1]))
        return ((2 * torch.rand(*shape, generator=gen) - 1) * lim).to(device)
    mask = (torch.rand(n, 1, generator=gen) > 0.25).float().to(device)
    msgs = (0.5 + 1.5 * torch.rand(f, generator=gen)).to(device) + r(n, f)
    gru = {"w_ih": xavier(f, 3 * f), "w_hh": xavier(f, 3 * f),
           "b_ih": r(3 * f, sc=0.1), "b_hh": r(3 * f, sc=0.1)}
    ma = {"weight": 0.5 + torch.rand(f, generator=gen).to(device),
          "bias": r(f)}
    bn = {"weight": 0.5 + torch.rand(f, generator=gen).to(device),
          "bias": r(f)}
    h0 = r(n, f)
    leaves = {"msgs": msgs, "h0": h0, **gru,
              **{f"ma_{k}": v for k, v in ma.items()},
              **{f"bn_{k}": v for k, v in bn.items()}}
    for v in leaves.values():
        v.requires_grad_()
    return (msgs, h0, mask, gru, ma, bn), leaves, r(n, f)


# recurrence_bwd's forced routes (_rec_route): every route of its rule,
# and a tile of 16 nodes that leaves a block's nodes in global scratch
REC_ROUTES = ("cluster 1", "cluster 2", "cluster 4", "cluster 8", "grid",
              "spilled")


def _rec_route(route, grid=None):
    """Force recurrence_bwd's route for the launches inside (kernels/
    recurrence.py::launch_shape; _forced_bwd_shape). The GPU tests, the
    emulator's checks and scripts/time_recurrence.py --sweep force routes
    through it."""
    from mpnn_tpu_torch.kernels import recurrence as R
    return _forced_bwd_shape(R, route, grid, lambda s, tag, steps, *_: (
        s._replace(ncap=16, smem_bytes=4 * R.bwd_smem_floats(
            tag, steps, 16))))


@contextlib.contextmanager
def _rec_fwd_route(route, grid=None):
    """Force recurrence_fwd's route (kernels/recurrence.py::
    fwd_launch_shape) for the launches inside: None (the rule's own
    choice), 'cluster C', 'grid' (`grid` blocks, by default one per
    FWD_GRID_NODES of the n slots, at least 2, at most 128), 'spilled' (a
    block per 128 slots, at least 2, with 16-node tiles: blocks keep their
    slots in global scratch), as _fwd_route forces the shared family's
    forward."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import recurrence as R
    keep = R.device_fwd_shape

    def forced(n, tag, steps, device):
        s = keep(n, tag, steps, device)
        if route is None:
            return s
        if route.startswith("cluster"):
            s = s._replace(route="cluster", grid=int(route.split()[1]))
        else:
            per = 128 if route == "spilled" else K.FWD_GRID_NODES
            s = s._replace(route="grid",
                           grid=grid or min(128, max(2, -(-n // per))))
        smem = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
        cap = (16 if route == "spilled" else
               min(s.ncap, R.fwd_capacity(tag, steps, smem, s.grid)))
        return s._replace(ncap=cap, ecap=0, smem_bytes=4 * R.fwd_smem_floats(
            tag, steps, cap, s.grid))
    R.device_fwd_shape = forced
    try:
        yield
    finally:
        R.device_fwd_shape = keep


# recurrence_fwd's forced routes (_rec_fwd_route): every route of its
# rule, and a tile of 16 nodes that leaves a block's slots in global
# scratch
REC_FWD_ROUTES = ("cluster 1", "cluster 2", "cluster 4", "cluster 8",
                  "grid", "spilled")


def phase_rec_kernel_check(device):
    """recurrence_fwd and recurrence_bwd against reference_recurrence under
    autograd on the card, T 6 at f 10 and f 30 (the wide bucket), at b16's
    node slots, b1024's (16,512) and 32,896, a random mask: h_T, both
    statistics and every gradient leaf (each divided by its max abs)
    within rtol 1e-4 / atol 1e-5; then the serving launch (no residuals);
    the backward on every forced route of its rule (_rec_route), twice
    for the same bits; then at N(0, 0.3²) GRU weights the kernels within
    the same tolerance of a float64 run, the plain chain's distance from
    it beside them."""
    import torch
    from mpnn_tpu_torch.kernels import recurrence as R
    gen = torch.Generator().manual_seed(83)
    n16 = int(_batch(SMILES * 2, 16)["node_mask"].shape[0])
    worst = {"recurrence_fwd": 0.0, "recurrence_bwd": 0.0}
    results, failed = [], []
    for n in (n16, *REC_NODES):
        for f in (10, 30):
            args, leaves, g = rec_case(n, f, gen, device)
            R.reset_launch_counts()
            got = rec_value_and_grads(R.recurrence, args, leaves, g,
                                      DEC_STEPS)
            with torch.no_grad():
                served = R.recurrence(*args, steps=DEC_STEPS)[0]
            torch.cuda.synchronize()
            counts = dict(R.launch_counts)
            want = rec_value_and_grads(R.reference_recurrence, args,
                                       leaves, g, DEC_STEPS)
            oks, errs = zip(*[_within(x, y)[:2]
                              for x, y in zip(got[0], want[0])])
            ok_s, err_s, _ = _within(served, want[0][0])
            gerr, ok_g = 0.0, True
            for k, w in want[1].items():
                ok_k, e_k, _ = _scaled_within(got[1][k], w)
                ok_g, gerr = ok_g and ok_k, max(gerr, e_k)
            ok = (all(oks) and ok_s and ok_g and counts == {
                "recurrence_fwd": 2, "recurrence_bwd": 1})
            worst["recurrence_fwd"] = max(worst["recurrence_fwd"], *errs,
                                          err_s)
            worst["recurrence_bwd"] = max(worst["recurrence_bwd"], gerr)
            results.append(
                f"N={n} f={f} ({int(args[2].sum())} real rows): h_T "
                f"max_abs={errs[0]:.3e} stats max_abs="
                f"{max(errs[1:]):.3e} serving {err_s:.3e} grads "
                f"max_scaled={gerr:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"N={n} f={f}: {counts}")
    # recurrence_bwd on every forced route, twice for the same bits
    route_cases = ([(n16, 10, r) for r in REC_ROUTES]
                   + [(REC_NODES[0], 10, "cluster 8"),
                      (REC_NODES[0], 30, "grid"),
                      (REC_NODES[0], 30, "spilled"),
                      (REC_NODES[-1], 10, "spilled")])
    routed = []
    for n, f, route in route_cases:
        args, leaves, g = rec_case(n, f, gen, device)
        with _rec_route(route):
            R.reset_launch_counts()
            got = rec_value_and_grads(R.recurrence, args, leaves, g,
                                      DEC_STEPS)
            again = rec_value_and_grads(R.recurrence, args, leaves, g,
                                        DEC_STEPS)
            torch.cuda.synchronize()
            shape = R.device_bwd_shape(n, "" if f <= 16 else "f32",
                                       DEC_STEPS, device)
        counts = dict(R.launch_counts)
        want = rec_value_and_grads(R.reference_recurrence, args, leaves, g,
                                   DEC_STEPS)
        gerr, ok_g = 0.0, True
        for k, w in want[1].items():
            ok_k, e_k, _ = _scaled_within(got[1][k], w)
            ok_g, gerr = ok_g and ok_k, max(gerr, e_k)
        same = all(torch.equal(got[1][k], again[1][k]) for k in got[1])
        ok = (ok_g and same and _route_matches(shape, route) and counts
              == {"recurrence_fwd": 2, "recurrence_bwd": 2})
        worst["recurrence_bwd"] = max(worst["recurrence_bwd"], gerr)
        routed.append(f"N={n} f={f} {shape.tag()} {gerr:.2e}"
                      + ("" if same else " BITS DIFFER")
                      + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"N={n} f={f} {route}: {counts}")
    results.append("recurrence_bwd on forced routes (twice for the same "
                   "bits): " + ", ".join(routed))
    # recurrence_fwd on every forced route and the rule's, training and
    # serving, twice for the same bits
    routed = []
    fwd_cases = ([(n16, 10, r) for r in (None, *REC_FWD_ROUTES)]
                 + [(REC_NODES[0], 10, None), (REC_NODES[0], 30, None),
                    (REC_NODES[0], 10, "cluster 8"),
                    (REC_NODES[0], 30, "grid"),
                    (REC_NODES[0], 30, "spilled"),
                    (REC_NODES[-1], 10, None), (REC_SPLIT_NODES, 10, None),
                    (REC_SPLIT_NODES, 30, None)])
    for n, f, route in fwd_cases:
        args, leaves, g = rec_case(n, f, gen, device)
        want = rec_value_and_grads(R.reference_recurrence, args, leaves, g,
                                   DEC_STEPS)[0]
        with _rec_fwd_route(route):
            R.reset_launch_counts()
            with torch.no_grad():
                runs = [R.recurrence(*args, steps=DEC_STEPS)
                        for _ in range(2)]
            got = [rec_value_and_grads(R.recurrence, args, leaves, g,
                                       DEC_STEPS)[0] for _ in range(2)]
            torch.cuda.synchronize()
            shape = R.device_fwd_shape(n, "" if f <= 16 else "f32",
                                       DEC_STEPS, device)
        counts = dict(R.launch_counts)
        flat = lambda o: [o[0], *o[1], *(x for st in o[2] for x in st)]
        errs = [_within(x, y) for x, y in zip(got[0], want)]
        errs += [_within(x, y) for x, y in zip(flat(runs[0]), flat(want))]
        ef = max(e[1] for e in errs)
        same = all(torch.equal(x, y) for x, y in zip(flat(runs[0]),
                                                    flat(runs[1]))) and all(
            torch.equal(x, y) for x, y in zip(got[0], got[1]))
        ok = (all(e[0] for e in errs) and same
              and _route_matches(shape, route)
              and counts == {"recurrence_fwd": 4, "recurrence_bwd": 2})
        worst["recurrence_fwd"] = max(worst["recurrence_fwd"], ef)
        routed.append(f"N={n} f={f} {shape.tag()} {ef:.2e}"
                      + ("" if same else " BITS DIFFER")
                      + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"recurrence_fwd N={n} f={f} {route}: {counts}")
    results.append("recurrence_fwd on forced routes, training and serving "
                   "(twice for the same bits): " + ", ".join(routed))
    # past the init scale: GRU weights N(0, 0.3²) at b1024's slots and f
    # 30, the kernels and the plain chain each against a float64 run
    args, leaves, g = rec_case(REC_NODES[0], 30, gen, device, weight_sd=0.3)
    exact = rec_float64(args, leaves, g, DEC_STEPS)
    dists = {}
    for name, fn in (("kernels", R.recurrence),
                     ("plain", R.reference_recurrence)):
        dists[name] = rec_distances(
            rec_value_and_grads(fn, args, leaves, g, DEC_STEPS), exact)
    ef, eg, ok = dists["kernels"]
    worst["recurrence_fwd"] = max(worst["recurrence_fwd"], ef)
    worst["recurrence_bwd"] = max(worst["recurrence_bwd"], eg)
    results.append(
        f"N={REC_NODES[0]} f=30 GRU weights N(0, 0.3²) against a float64 "
        f"run: kernels h_T and stats max_abs={ef:.3e} grads max_scaled="
        f"{eg:.3e} {'ok' if ok else 'FAIL'}, plain chain h_T and stats "
        f"max_abs={dists['plain'][0]:.3e} grads max_scaled="
        f"{dists['plain'][1]:.3e} (within: {dists['plain'][2]})")
    if not ok:
        failed.append(f"N={REC_NODES[0]} f=30 N(0, 0.3²) weights: the "
                      f"kernels off the float64 run")
    print(f"rec-kernel-check: recurrence_fwd (training and serving) and "
          f"recurrence_bwd vs reference_recurrence under autograd (T "
          f"{DEC_STEPS}; rtol {RTOL} atol {ATOL}, the 10 gradient leaves "
          f"divided by their max abs): " + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"the recurrence kernels disagree with their "
                           f"plain version: {failed}")
    return worst


def rec_float64(args, leaves, g, steps):
    """rec_value_and_grads of reference_recurrence on float64 copies of
    a rec_case (the mask and the cotangent too), for distances of float32
    runs from the exact chain."""
    import torch
    from mpnn_tpu_torch.kernels import recurrence as R
    d = {k: v.detach().double().requires_grad_() for k, v in leaves.items()}
    args64 = (d["msgs"], d["h0"], args[2].double(),
              {k: d[k] for k in args[3]},
              {k: d[f"ma_{k}"] for k in args[4]},
              {k: d[f"bn_{k}"] for k in args[5]})
    return rec_value_and_grads(R.reference_recurrence, args64, d,
                               g.double(), steps)


def rec_distances(got, exact):
    """(largest abs distance of h_T and the statistics, largest distance
    of a gradient leaf divided by its max abs, whether all lie within
    rtol 1e-4 / atol 1e-5) of a float32 run `got` from a float64 run
    `exact`, both as rec_value_and_grads gives them."""
    ok, ef, eg = True, 0.0, 0.0
    for x, y in zip(got[0], exact[0]):
        ok_x, e_x, _ = _within(x.double(), y)
        ok, ef = ok and ok_x, max(ef, e_x)
    for k, w in exact[1].items():
        ok_k, e_k, _ = _scaled_within(got[1][k].double(), w)
        ok, eg = ok and ok_k, max(eg, e_k)
    return ef, eg, ok


def rec_value_and_grads(fn, args, leaves, g, steps):
    """((h_T, ma statistics, step statistics), {leaf: gradient}) of the
    recurrence op `fn` for the cotangent g of h_T."""
    import torch
    ht, ma, st = fn(*args, steps=steps)
    grads = torch.autograd.grad((ht * g).sum(), list(leaves.values()))
    return ((ht.detach(), torch.stack(ma),
             torch.stack([torch.stack(s) for s in st])),
            dict(zip(leaves, grads)))


@contextlib.contextmanager
def _deterministic_torch():
    """PyTorch's deterministic algorithms within the block (its index_add_
    and scatter sums in a fixed order instead of float atomics; an op
    without such a version runs as it is, its warning silenced), the
    previous setting restored after it."""
    import warnings
    import torch
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _dec_first_grads(cfg, tcfg, batch, device, deterministic=True):
    """The first step's parameter gradients from the trainer's initial
    weights (seed tcfg.seed) on `batch`, three ways: the decomposed hooks
    (float32), the plain model in float32, and the plain model in float64
    (weights and the batch's floats cast up) as the exact reference. By
    default under PyTorch's deterministic algorithms: the kernels sum in a
    fixed order, but the PyTorch ops around them (the readout's index_add_
    and others) add with float atomics on the card, and lipo's message-
    network gradient, behind the message batch norm's cancellation, moves
    with that order by about the tolerance (PERF.md, PR 9;
    scripts/dec_grad_noise.py). Returns ({leaf: gradient} for each, in
    that order)."""
    import torch
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train.trainer import batch_loss, decomposed_hooks

    def grads(hooks, dtype):
        n = network_init(cfg, torch.Generator().manual_seed(tcfg.seed),
                         device).to(dtype)
        b = {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                 else v) for k, v in batch.items()}
        out, _ = network_apply_packed(n, b, fused=False, training=True,
                                      hooks=hooks)
        batch_loss(tcfg.loss, out, b).backward()
        return {k: p.grad for k, p in n.named_parameters()
                if p.grad is not None}

    with (_deterministic_torch() if deterministic
          else contextlib.nullcontext()):
        return (grads(decomposed_hooks(cfg, tcfg), torch.float32),
                grads(None, torch.float32), grads(None, torch.float64))


def _grad_distance(cfg, got, exact):
    """How far the leaves of `got` lie from `exact` (float64), each
    divided by exact's max abs: (the largest |difference| / (atol 1e-5 +
    rtol 1e-4 · |exact|), at most 1 where all lie within; its leaf; the
    largest difference). message_bias under the message bn1d is zero in
    theory, its float32 gradient rounding alone: held to atol unscaled."""
    margin, where, worst = 0.0, None, 0.0
    for k, w in exact.items():
        d = got[k].double() - w
        if k.endswith("message_bias") and cfg.mpnn.msg_norm == "bn1d":
            m_k, e_k = float(d.abs().max()) / ATOL, 0.0
        else:
            scale = w.abs().max().clamp_min(1e-30)
            d, ws = (d / scale).abs(), (w / scale).abs()
            m_k, e_k = float((d / (ATOL + RTOL * ws)).max()), float(d.max())
        if m_k >= margin:
            margin, where = m_k, k
        worst = max(worst, e_k)
    return margin, where, worst


def _dec_first_steps(what, cfg, tcfg, train_gs, device, steps):
    """The first 3 steps of a run against the plain path on the card from
    the trainer's initial weights (seed 317) on its first shuffled
    batches: the run's logged losses within rtol 1e-3; and the first
    step's parameter gradients through the decomposed hooks against the
    plain model run in float64 (_dec_first_grads), each divided by its max
    abs within rtol 1e-4 / atol 1e-5. The plain float32 model's own
    distance from float64 is measured beside it: it is itself a float32
    computation, not an exact reference. Returns (max rel loss difference,
    the hooks' max scaled gradient distance from float64, the plain
    float32 model's)."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    loader = G.GraphLoader(train_gs, tcfg.batch_size, shuffle=True,
                           seed=tcfg.seed)
    batches = [batch_to_device(b, device) for b, _ in zip(loader, range(3))]
    net = network_init(cfg, torch.Generator().manual_seed(tcfg.seed),
                       device)
    opt = adam(net.parameters(), tcfg.learning_rate,
               weight_decay=tcfg.weight_decay)
    plain = [float(train_step(net, opt, b, fused=False, loss_kind=tcfg.loss))
             for b in batches]
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if rel > 1e-3:
        raise RuntimeError(f"{what}: first steps {steps[:3]} vs plain path "
                           f"{plain} (rel {rel:.2e} > 1e-3)")
    dec, p32, exact = _dec_first_grads(cfg, tcfg, batches[0], device)
    if set(dec) != set(exact) or set(p32) != set(exact):
        raise RuntimeError(f"{what}: the paths reach other leaves")
    margin, where, worst = _grad_distance(cfg, dec, exact)
    p_margin, _, p_worst = _grad_distance(cfg, p32, exact)
    if margin > 1:
        raise RuntimeError(f"{what}: first-step gradient of {where}: "
                           f"{margin:.2f} of the tolerance from float64 "
                           f"(max scaled {worst:.3e}; the plain float32 "
                           f"model: {p_margin:.2f}, {p_worst:.3e})")
    return rel, worst, p_worst


def _dec_run(what, argv=None, api=None):
    """One decomposed training run, the `train` verb (argv) or
    trainer.train (api: (cfg, tcfg, train_gs, val_gs)), the launch
    counts set to 0 just before it; returns (per-step losses, epoch
    records, wall seconds)."""
    import torch
    from mpnn_tpu_torch.train import cli, trainer
    _dec_reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    if argv is not None:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        log = argv[argv.index("--log") + 1]
    else:
        cfg, tcfg, train_gs, val_gs = api
        trainer.train(cfg, tcfg, train_gs, val_gs, device="cuda")
        log = tcfg.log_path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(log) as fh:
        recs = [json.loads(x) for x in fh if x.strip()]
    steps = [r["loss"] for r in recs if "step" in r]
    epochs = [r for r in recs if "train_loss" in r]
    if not (steps and all(math.isfinite(x) for x in steps)
            and all(math.isfinite(r["val_loss"]) for r in epochs)):
        raise RuntimeError(f"{what}: non-finite or no loss")
    return steps, epochs, wall


def phase_dec_train(device):
    """The decomposed training path on the card, each run's launch counts
    set to 0 just before it and read just after, against the design: the
    `train --spmm kernel` verb on lipo (2 epochs at 16: per step 2
    spmm_fwd — the forward and dh — 1 spmm_da, the edge-MLP chain's 1 + 1;
    the step loop in PyTorch ops; per validation and test batch one eval
    launch and its edge-MLP forward), then `predict` from its checkpoint;
    trainer.train with fuse_step=False, fuse_recurrence=True (the same
    plus 1 recurrence_fwd and 1 recurrence_bwd per step); `train --spmm
    kernel` of graph_norm_classification (1 epoch: T forwards per step,
    T spmm_da, and T dh launches only where h0 takes a gradient — the
    model's plain wrapper and no encoders: none); and one lipo run at the
    wide phase's afm 27. Each: the first 3 losses against the plain path
    (rtol 1e-3) and the first step's parameter gradients (1e-4 / 1e-5,
    scaled)."""
    import dataclasses
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.train import cli, experiments
    from mpnn_tpu_torch.train.split import train_test_split
    os.makedirs(OUT_DIR, exist_ok=True)
    lines = []

    def split(gs):
        tr, te = train_test_split(gs, 0.1, 317)
        tr, va = train_test_split(tr, 0.1, 317)
        return tr, va, te

    def n_batches(gs, bs):
        return -(-len(gs) // bs)

    def want(n_steps, n_evals, nets, dh, rec, psteps=False):
        return {"spmm_fwd": n_steps * nets * (1 + dh),
                "spmm_da": n_steps * nets,
                "recurrence_fwd": n_steps * rec,
                "recurrence_bwd": n_steps * rec,
                "edge_mlp_fwd": nets * (n_steps + n_evals),
                "edge_mlp_bwd": nets * n_steps,
                "fused_eval": 0 if psteps else n_evals,
                "fused_psteps_eval": n_evals if psteps else 0}

    lipo = experiments.get("lipo")
    csv = _train_csv(TRAIN_ROWS)
    gs, _ = G.load_number_dataset(csv, "smiles", "exp")
    tr, va, te = split(gs)
    cfg = zoo.lipo(int(gs[0].afm.shape[-1]), int(gs[0].bfm.shape[-1]),
                   int(gs[0].nafm.shape[-1]))
    # 1. the verb
    log = os.path.join(OUT_DIR, "dec_train_lipo.jsonl")
    ckdir = os.path.join(OUT_DIR, "dec_ckpt_lipo")
    if os.path.exists(log):
        os.remove(log)
    steps, epochs, wall = _dec_run("dec-train verb", argv=[
        "train", "--experiment", "lipo", "--data", csv, "--epochs",
        str(TRAIN_EPOCHS), "--batch-size", str(TRAIN_BATCH), "--ckpt-dir",
        ckdir, "--log", log, "--spmm", "kernel"])
    n_steps = TRAIN_EPOCHS * n_batches(tr, TRAIN_BATCH)
    n_evals = (TRAIN_EPOCHS * n_batches(va, TRAIN_BATCH)
               + n_batches(te, TRAIN_BATCH))
    counts = _dec_take("dec-train verb", want(n_steps, n_evals, 1, 1, 0))
    tcfg = dataclasses.replace(lipo.train, fuse_step=False)
    rel, gerr, perr = _dec_first_steps(
        "dec-train verb", cfg, tcfg, tr, device, steps)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["predict", "--experiment", "lipo", "--data", csv,
                  "--ckpt", os.path.join(ckdir,
                                         f"ckpt_{TRAIN_EPOCHS - 1}.npz"),
                  "--batch-size", "64"])
    preds = [json.loads(x)["pred"] for x in buf.getvalue().splitlines() if x]
    if len(preds) != TRAIN_ROWS or not all(math.isfinite(p) for p in preds):
        raise RuntimeError("dec-train: predict from the checkpoint failed")
    lines.append(
        f"`train --spmm kernel` lipo ({len(tr)} train molecules, batch "
        f"{TRAIN_BATCH}, {TRAIN_EPOCHS} epochs): {len(steps)} steps in "
        f"{wall:.2f} s wall, launches {counts}; first 3 losses vs plain "
        f"max rel {rel:.2e}, first-step gradients max_scaled {gerr:.3e} "
        f"from float64 (plain float32 {perr:.3e}); "
        f"val_loss {[round(r['val_loss'], 5) for r in epochs]}; predict "
        f"from the checkpoint: {len(preds)} finite predictions")
    # 2. the API with the fused recurrence
    log = os.path.join(OUT_DIR, "dec_train_lipo_rec.jsonl")
    if os.path.exists(log):
        os.remove(log)
    tcfg = dataclasses.replace(lipo.train, epochs=TRAIN_EPOCHS,
                               fuse_step=False, fuse_recurrence=True,
                               log_path=log)
    steps, epochs, wall = _dec_run("dec-train api",
                                   api=(cfg, tcfg, tr, va))
    n_evals = TRAIN_EPOCHS * n_batches(va, TRAIN_BATCH)
    counts = _dec_take("dec-train api", want(n_steps, n_evals, 1, 1, 1))
    rel, gerr, perr = _dec_first_steps(
        "dec-train api", cfg, tcfg, tr, device, steps)
    lines.append(
        f"trainer.train(fuse_step=False, fuse_recurrence=True) lipo: "
        f"{len(steps)} steps in {wall:.2f} s wall, launches {counts}; "
        f"first 3 losses vs plain max rel {rel:.2e}, first-step gradients "
        f"max_scaled {gerr:.3e} from float64 (plain float32 "
        f"{perr:.3e})")
    # 3. the per-step family through the verb
    exp = experiments.get("graph_norm_classification")
    pcsv = _ps_csv("dec_graph_norm", TRAIN_ROWS)
    log = os.path.join(OUT_DIR, "dec_train_graph_norm.jsonl")
    if os.path.exists(log):
        os.remove(log)
    pgs = G.load_classification_dataset(pcsv, "smiles", "target")[0]
    ptr, pva, pte = split(pgs)
    pcfg = zoo.build(exp.model, afm=int(pgs[0].afm.shape[-1]),
                     bfm=int(pgs[0].bfm.shape[-1]),
                     nafm=int(pgs[0].nafm.shape[-1]), n_out=PS_CLASSES)
    steps, epochs, wall = _dec_run("dec-train graph_norm", argv=[
        "train", "--experiment", exp.name, "--data", pcsv, "--epochs", "1",
        "--log", log, "--spmm", "kernel"])
    bs = exp.train.batch_size
    counts = _dec_take("dec-train graph_norm", want(
        n_batches(ptr, bs), n_batches(pva, bs) + n_batches(pte, bs),
        pcfg.mpnn.message_steps, 0, 0, psteps=True))
    rel, gerr, perr = _dec_first_steps(
        "dec-train graph_norm", pcfg,
        dataclasses.replace(exp.train, fuse_step=False), ptr, device, steps)
    lines.append(
        f"`train --spmm kernel` graph_norm_classification (T "
        f"{pcfg.mpnn.message_steps}, 1 epoch): {len(steps)} steps in "
        f"{wall:.2f} s wall, launches {counts}; first 3 losses vs plain "
        f"max rel {rel:.2e}, first-step gradients max_scaled {gerr:.3e} "
        f"from float64 (plain float32 {perr:.3e})")
    # 4. lipo at the wide widths (afm 27: the SpMM's and the recurrence's
    #    wide buckets)
    wcsv = _wide_csv("dec_lipo", "mse", "exp")
    wgs, _ = G.load_number_dataset(wcsv, "smiles", "exp")
    wtr, wva, _ = split(wgs)
    wcfg = zoo.lipo(int(wgs[0].afm.shape[-1]), int(wgs[0].bfm.shape[-1]),
                    int(wgs[0].nafm.shape[-1]))
    log = os.path.join(OUT_DIR, "dec_train_wide.jsonl")
    if os.path.exists(log):
        os.remove(log)
    tcfg = dataclasses.replace(lipo.train, epochs=1, fuse_step=False,
                               fuse_recurrence=True, log_path=log)
    steps, epochs, wall = _dec_run("dec-train wide",
                                   api=(wcfg, tcfg, wtr, wva))
    counts = _dec_take("dec-train wide", want(
        n_batches(wtr, TRAIN_BATCH), n_batches(wva, TRAIN_BATCH), 1, 1, 1))
    rel, gerr, perr = _dec_first_steps(
        "dec-train wide", wcfg, tcfg, wtr, device, steps)
    lines.append(
        f"wide lipo (f {wcfg.mpnn.node_features}, od "
        f"{wcfg.mpnn.output_dim}; trainer.train, fuse_recurrence): "
        f"{len(steps)} steps in {wall:.2f} s wall, launches {counts}; "
        f"first 3 losses vs plain max rel {rel:.2e}, first-step gradients "
        f"max_scaled {gerr:.3e} from float64 (plain float32 "
        f"{perr:.3e})")
    print("dec-train: " + "; ".join(lines), flush=True)


def _spmm_bounds(nr, er, k, f):
    """Least times of the SpMM kernels' work: the larger of the float32
    operations over the peak CUDA-core rate and the bytes of the
    function's own inputs and outputs (each read or written once; the
    real rows and edges; not the index plan) over HBM bandwidth. Forward:
    a GEMV per real edge, reading A, h, vid/src/dst, writing out. dA: an
    outer product per real edge, reading g, h, vid/src/dst, writing dA."""
    ops = 2.0 * er * f * f
    fwd_bytes = 4 * (k * f * f + nr * f + 3 * er + nr * f)
    da_bytes = 4 * (2 * nr * f + 3 * er + k * f * f)
    out = {}
    for name, nbytes in (("spmm_fwd", fwd_bytes), ("spmm_da", da_bytes)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def _spmm_phases(p):
    """spmm_fwd's clock64 stamps of block 0 (its tile; cycles) as phases:
    the indices, the x rows with the used ids' tables, the products, the
    tile's row sums with the combine of rows crossing tiles, the rows
    without edges zeroed."""
    return {"indices": p[1] - p[0], "rows and tables": p[2] - p[1],
            "products": p[3] - p[2], "row sums and combine": p[4] - p[3],
            "empty rows": p[5] - p[4], "total": p[5] - p[0]}


def _spmm_detail(prep, device):
    """spmm_fwd's tiles, the empty-kernel floor (the same tiles, index
    staging and combines with no arithmetic: CUDA events over 100
    launches, and the device time a launch in a trace of 20) and one
    launch's clock64 phases; prep(**kw) prepares a launch on the inputs.
    Leaves the launch counts as they were."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import spmm as S
    counts = dict(S.launch_counts)
    fl = prep(floor=True)
    floor = (_events_ms(lambda: K.launch_prepared(fl), 100),
             _kernel_trace_us_n(20, fl)[0] / 20 / 1e3)
    prof = torch.zeros(S.PROF_SLOTS, dtype=torch.int64, device=device)
    p = prep(prof=prof)
    K.launch_prepared(p)
    torch.cuda.synchronize()
    S.launch_counts.update(counts)
    a, _, _, _, _, order = p.keep[:6]
    shape = S.device_shape(order.shape[0], a.shape[1], a.shape[2],
                           a.shape[0], device)
    return shape.tag(), floor, _spmm_phases(prof.tolist())


def _spmm_detail_text(what, detail):
    tag, (f_ms, f_trace), phases = detail
    return (f"spmm_fwd {what} tiles {tag}, empty kernel "
            f"{f_ms * 1e3:.2f} us (trace {f_trace * 1e3:.2f}), block 0 "
            f"(cycles): " + ", ".join(f"{k} {v:.0f}"
                                      for k, v in phases.items()))


def _rec_bounds(n, nr, f, steps):
    """Least times of the recurrence kernels' work, as _spmm_bounds
    counts it: each kernel's function on its own inputs. The forward
    (h_T and the statistics, as the serving launch computes them) takes
    the message norm, the input gates once (the messages are constant)
    and per step one W_hh GEMV, the gate math and the state norm, reading
    msgs, h0 (real rows), the mask (n slots) and the weights, writing h_T
    and the statistics; the T pre-norm states that the training launch
    also writes are the backward's residuals, not the function's output.
    The backward (the VJP from the forward's inputs and h_T's cotangent)
    charges the residuals once, as the work that rebuilds them: per step
    the hidden gates' GEMV, gate math and norm again, W_hhᵀ·∂g and the
    ∂W_hh outer product, the gate and norm VJPs; once the input gates,
    W_ih·Σ∂gi, the ∂W_ih outer product and the message norm with its VJP;
    reading the forward's inputs and the cotangent, writing ∂msgs, ∂h0
    and the weight gradients."""
    gemv = 2 * f * 3 * f
    gate = 3 * f + 12 * f
    norm = 8 * f
    weights = 6 * f * f + 10 * f
    stats = 2 * (steps + 1) * f
    inputs = 2 * nr * f + n + weights
    fwd_ops = nr * (norm + gemv + 3 * f) + steps * nr * (gemv + gate + norm)
    fwd_bytes = 4 * (inputs + nr * f + stats)
    bwd_ops = (steps * nr * (3 * gemv + gate + 20 * f + 2 * norm)
               + nr * (3 * gemv + 2 * norm))
    bwd_bytes = 4 * (inputs + nr * f + 2 * nr * f + weights)
    out = {}
    for name, ops, nbytes in (("recurrence_fwd", fwd_ops, fwd_bytes),
                              ("recurrence_bwd", bwd_ops, bwd_bytes)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def _dec_trace(what, step, kernels, step_ms):
    """One decomposed b1024 train step (`step()`, which returns the loss)
    in a torch.profiler trace: (busy us, a line with the busy time, the
    device ops, the idle share of the step's median and each of
    `kernels`' device time); fails when one of them shows none. The
    trace reads the second of two steps, the first the profiler's
    warm-up (_trace)."""
    prof, busy, ops, kern = _trace_kernels(lambda: float(step()), kernels)
    with open(os.path.join(OUT_DIR, f"profile_dec_{what}_train_1024.txt"),
              "w") as fh:
        fh.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    if min(kern.values()) <= 0:
        raise RuntimeError(f"dec times: the trace shows no device time for "
                           f"{sorted(k for k, v in kern.items() if v <= 0)}")
    return busy, (
        f"decomposed {what} b1024 step in a trace: device busy {busy:.1f} "
        f"us in {sum(e.count for e in ops)} device ops, idle share "
        f"{1 - busy / (step_ms * 1e3):.3f} of the {step_ms:.3f} ms median; "
        + ", ".join(f"{k}_kernel {v:.1f} us" for k, v in sorted(kern.items())))


def phase_dec_times(device, card):
    """The decomposed lipo train step (the SpMM, recurrence and edge-MLP
    kernels; host clock ending in the loss read-back) at batch 16 and
    1024 beside the whole-step path's on the same batch and weights, in
    turns (whole, decomposed, decomposed, whole); at b1024 each new
    kernel's time (CUDA events over back-to-back launches on the step's
    own inputs) beside its bound and its plain version's time (autograd
    through it for a backward), and the decomposed step's device busy
    time and idle share from a profiler trace."""
    import statistics
    import torch
    from mpnn_tpu_torch.graphs.batching import (plan_from_batch,
                                                plan_fused_eval)
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import recurrence as R
    from mpnn_tpu_torch.kernels import spmm as S
    from mpnn_tpu_torch.models.fused_train import _build_a_form, _edge_mlp_op
    from mpnn_tpu_torch.models.network import mpnn_input
    from mpnn_tpu_torch.train.trainer import (TrainConfig, batch_to_device,
                                              decomposed_hooks, train_step)
    gen = torch.Generator().manual_seed(85)
    out, lines = {}, []
    for bs in DEC_TIMES_BATCHES:
        b = _batch((SMILES * (bs // len(SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randn(bs, generator=gen).numpy()
        tb = batch_to_device(b, device)
        net, opt = _train_net(b, gen, device)
        hooks = decomposed_hooks(net.cfg, TrainConfig(fuse_step=False,
                                                      fuse_recurrence=True))
        reps = 30 if bs <= 16 else 15

        def timed(fused):
            kw = dict(hooks=None if fused else hooks)
            for _ in range(3):
                float(train_step(net, opt, tb, **kw))
            lat = []
            for _ in range(reps):
                t0 = time.perf_counter()
                float(train_step(net, opt, tb, **kw))
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            return lat
        whole, dec = timed(True), timed(False)
        dec += timed(False)
        whole += timed(True)
        out[bs] = dict(step_ms=statistics.median(dec),
                       whole_ms=statistics.median(whole))
        line = (f"batch {bs} (nodes {int(b['node_mask'].sum())}/"
                f"{b['node_mask'].shape[0]}, edges "
                f"{int(b['edge_mask'].sum())}/{b['edge_src'].shape[0]}): "
                f"decomposed train step median {out[bs]['step_ms']:.3f} ms "
                f"mean {statistics.fmean(dec):.3f} ms, whole-step median "
                f"{out[bs]['whole_ms']:.3f} ms mean "
                f"{statistics.fmean(whole):.3f} ms ({2 * reps} reps each, "
                f"in turns, loss read back)")
        if bs == DEC_TIMES_BATCHES[-1]:
            # the kernels alone, on the inputs the step gives them
            with torch.no_grad():
                mb, _ = mpnn_input(net, tb, training=True)
                amat, _, vid = _build_a_form(net.mpnn, mb,
                                             _edge_mlp_op(net.cfg.mpnn))
                h0 = (mb["node_feats"] * mb["node_mask"]).contiguous()
                amat = amat.contiguous()
                src, dst = tb["edge_src"], tb["edge_dst"]
                plan = plan_from_batch(tb)
                n, f = h0.shape
                k = amat.shape[0]
                msgs = S.spmm_reference(amat, h0, vid, src, dst)
                g = torch.randn(n, f, generator=gen).to(device)
                pf = S.prepare_spmm_fwd(amat, h0, vid, src, dst,
                                        plan.edge_order, plan.dst_ptr,
                                        n_out=n)
                pd = S.prepare_spmm_da(h0, g, vid, src, dst, k)
                m = net.mpnn
                gru = {kk: v.detach() for kk, v in m.gru.as_dict().items()}
                weights = [gru["w_ih"], gru["w_hh"], gru["b_ih"],
                           gru["b_hh"], m.ma_bn[0].weight.detach(),
                           m.ma_bn[0].bias.detach(), m.bn[0].weight.detach(),
                           m.bn[0].bias.detach()]
                mask = tb["node_mask"]
                prf = R.prepare_recurrence_fwd(msgs, h0, mask, weights,
                                               steps=DEC_STEPS, stash=True)
                _, stats, htil = K.launch_prepared(prf)
                prb = R.prepare_recurrence_bwd(msgs, h0, mask, weights,
                                               stats, htil, g,
                                               steps=DEC_STEPS)
                ms = {p.name: _events_ms(lambda p=p: K.launch_prepared(p),
                                         100) for p in (pf, pd, prf, prb)}
                # the forward's device time, its transposed launch (dh),
                # their tiles, floors and phases
                s_order, s_ptr = K.source_order(src, n)
                at = amat.transpose(1, 2).contiguous()
                pdh = S.prepare_spmm_fwd(at, g, vid, dst, src, s_order,
                                         s_ptr, n_out=n)
                dh_ms = _events_ms(lambda: K.launch_prepared(pdh), 100)
                sf_trace, dh_trace = (_kernel_trace_us_n(20, p)[0] / 20
                                      for p in (pf, pdh))
                sdetail = "; ".join(_spmm_detail_text(w, _spmm_detail(
                    lambda **kw: S.prepare_spmm_fwd(*xs, n_out=n, **kw),
                    device)) for w, xs in (
                        ("forward", (amat, h0, vid, src, dst,
                                     plan.edge_order, plan.dst_ptr)),
                        ("dh", (at, g, vid, dst, src, s_order, s_ptr))))
                rb_trace = _kernel_trace_us_n(20, prb)[0] / 20
                rargs = (msgs, h0, mask, weights, stats, htil, g)
                rdetail = _detail_text("recurrence_bwd", *_walk_detail(
                    lambda **kw: R.prepare_recurrence_bwd(
                        *rargs, steps=DEC_STEPS, **kw),
                    lambda: R.device_bwd_shape(n, "" if f <= 16 else "f32",
                                               DEC_STEPS, device),
                    lambda pr: _rec_bwd_phases(pr, DEC_STEPS),
                    R.launch_counts, device))
                # the serving launch: h_T and the statistics alone, the
                # function that recurrence_fwd's bound counts
                prs = R.prepare_recurrence_fwd(msgs, h0, mask, weights,
                                               steps=DEC_STEPS, stash=False)
                serve_ms = _events_ms(lambda: K.launch_prepared(prs), 100)
                # the forward on the real edges alone: the padded edges
                # all end at the dummy node, whose row walks them in series
                er_i = int(b["edge_mask"].sum())
                real_plan = plan_fused_eval(b["edge_dst"][:er_i],
                                            b["node_graph"], bs)
                rp = [torch.as_tensor(x, device=device) for x in real_plan]
                pr = S.prepare_spmm_fwd(amat, h0, vid[:er_i].contiguous(),
                                        src[:er_i].contiguous(),
                                        dst[:er_i].contiguous(), rp[0],
                                        rp[1], n_out=n)
                real_ms = _events_ms(lambda: K.launch_prepared(pr), 100)
                dummy_edges = int((b["edge_dst"] == n - 1).sum())
                ma_d = {"weight": weights[4], "bias": weights[5]}
                bn_d = {"weight": weights[6], "bias": weights[7]}
                plain = {
                    "spmm_fwd": _events_ms(lambda: S.spmm_reference(
                        amat, h0, vid, src, dst), 20),
                    "spmm_da": _events_ms(lambda: S.spmm_da_reference(
                        h0, g, vid, src, dst, k), 20),
                    "recurrence_fwd": _events_ms(
                        lambda: R.reference_recurrence(
                            msgs, h0, mask, gru, ma_d, bn_d,
                            steps=DEC_STEPS), 20)}
            leaves = [x.detach().requires_grad_() for x in [msgs, h0]
                      + weights]
            ht, _, _ = R.reference_recurrence(
                leaves[0], leaves[1], mask,
                dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), leaves[2:6])),
                {"weight": leaves[6], "bias": leaves[7]},
                {"weight": leaves[8], "bias": leaves[9]}, steps=DEC_STEPS)
            obj = (ht * g).sum()
            plain["recurrence_bwd"] = _events_ms(lambda: torch.autograd.grad(
                obj, leaves, retain_graph=True), 20)
            nr, er = float(b["node_mask"].sum()), float(b["edge_mask"].sum())
            bounds = {**_spmm_bounds(nr, er, k, f),
                      **_rec_bounds(n, nr, f, DEC_STEPS)}
            for name in DEC_KERNELS:
                bound, by, ops, nbytes = bounds[name]
                out[bs][name] = dict(ms=ms[name], plain_ms=plain[name],
                                     bound_ms=bound, bound_by=by)
            out[bs]["recurrence_bwd"]["trace_ms"] = rb_trace / 1e3
            out[bs]["spmm_fwd"]["trace_ms"] = sf_trace / 1e3
            line += "; " + ", ".join(
                f"{name} {ms[name] * 1e3:.2f} us (events, 100 launches), "
                f"plain {plain[name] * 1e3:.1f} us, bound "
                f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
                f"({bounds[name][2] / 1e6:.3f} Mop, "
                f"{bounds[name][3] / 1e6:.3f} MB)" for name in DEC_KERNELS)
            line += (f" (K {k}, f {f}, T {DEC_STEPS}); recurrence_fwd "
                     f"without the residual stash (the serving launch) "
                     f"{serve_ms * 1e3:.2f} us; spmm_fwd on the "
                     f"{er_i} real edges alone {real_ms * 1e3:.2f} us (the "
                     f"dummy node's row takes the other {dummy_edges}); "
                     f"recurrence_bwd {rb_trace:.2f} us (trace); {rdetail}; "
                     f"spmm_fwd {sf_trace:.2f} us (trace), its dh launch "
                     f"{dh_ms * 1e3:.2f} us (events, trace {dh_trace:.2f}); "
                     f"{sdetail}")
            busy, traced = _dec_trace(
                "lipo", lambda: train_step(net, opt, batch_to_device(
                    b, device), hooks=hooks), DEC_KERNELS + MLP_KERNELS,
                out[bs]["step_ms"])
            out[bs]["busy_us"] = busy
            line += "; " + traced
        lines.append(line)
    print(f"dec-times [{card}]: " + "; ".join(lines), flush=True)
    return out


# ---------------------------------------------------------------------------
# the attention models' decomposed training path (adv, att): phases 34-36
# ---------------------------------------------------------------------------

SDDMM_KERNELS = ("sddmm_fwd", "sddmm_bwd")
# the SDDMM and set2vec kernels' launches on the main paths (dec-att-train),
# summed
DEC_ATT_MAIN = dict.fromkeys(SDDMM_KERNELS + ATT_KERNELS[2:], 0)
# dec-att-times' batch sizes; the kernels are timed at the last
DEC_ATT_BATCHES = (16, 1024)


def _sddmm_case(tb, f, k, gen, device, mf=None, ef=None):
    """(aprime, evocab, wa, ba, h, vid, src, dst, plan, gout) on a device
    batch: h and the cotangent gout random on every row, the padded rows
    and the dummy node's too (the padded edges all end at the dummy node
    with vid 0: they carry messages and gradients), aprime random with a
    row 0 that is not zero (the model's A'_0 = pen(0)·W̃ + Bf), evocab
    (K, ef), wa, ba random. k None: the batch's own vocabulary (its
    edge_vid, K its vocab capacity); else k ids drawn at random for the
    real edges, the padded edges keeping id 0."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    n = tb["node_mask"].shape[0]
    mf = f if mf is None else mf
    ef = int(tb["edge_feats"].shape[1]) if ef is None else ef
    vid = tb["edge_vid"]
    if k is None:
        k = int(tb["edge_vfirst"].shape[0])
    else:
        rnd = torch.randint(1, k, vid.shape, generator=gen,
                            dtype=torch.int32).to(device)
        vid = torch.where(tb["edge_mask"] > 0, rnd,
                          torch.zeros_like(rnd)).contiguous()

    def r(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen)).to(device)
    return (r(k, mf, f, s=0.3), r(k, ef), r(f + ef, f, s=0.3), r(f, s=0.1),
            r(n, f), vid, tb["edge_src"], tb["edge_dst"],
            plan_from_batch(tb), r(n, mf))


@contextlib.contextmanager
def _sddmm_route(per=None):
    """Force the SDDMM kernels' tiles (kernels/sddmm.py::launch_shape)
    inside the block: `per`, the positions a lane group takes in a tile
    and in a backward's vocab tile ((1, 1): the smallest tiles, every long
    row crossing them). A measurement's and a check's; the wrapper takes
    the rule's."""
    import torch
    from mpnn_tpu_torch.kernels import sddmm as D
    real = D.device_shape

    def forced(direction, n_edges, mf, nf, k_vocab, device):
        props = torch.cuda.get_device_properties(device)
        return D.launch_shape(
            direction, n_edges, mf, nf, k_vocab,
            smem_bytes=props.shared_memory_per_block_optin,
            sms=props.multi_processor_count, per=per)
    D.device_shape = forced
    try:
        yield
    finally:
        D.device_shape = real


def _hub_case(c, tb, hub, gen):
    """_sddmm_case's arguments with `hub` random real edges turned to end
    at one real node (a destination of hundreds of edges: its row crosses
    tiles) and the index plan rebuilt for it."""
    import numpy as np
    import torch
    from mpnn_tpu_torch.graphs.batching import FusedEvalPlan, plan_fused_eval
    dst = c[7].cpu().numpy().copy()
    real = np.nonzero(tb["edge_mask"].cpu().numpy() > 0)[0]
    pick = torch.randperm(len(real), generator=gen)[:hub].numpy()
    dst[real[pick]] = dst[real[len(real) // 2]]
    ng = tb["node_graph"].cpu().numpy()
    plan = FusedEvalPlan(*(torch.as_tensor(x, device=c[7].device)
                           for x in plan_fused_eval(
                               dst, ng, int(tb["graph_mask"].shape[0]))))
    return (*c[:7], torch.as_tensor(dst, device=c[7].device), plan, c[9])


# sddmm-kernel-check's tiles: (name, _sddmm_route's arguments); in "small
# tiles" a lane group takes one position, so long rows cross many tiles
SDDMM_ROUTES = {"rule": {}, "small tiles": dict(per=(1, 1))}


def phase_sddmm_kernel_check(device):
    """sddmm_fwd and sddmm_bwd against sddmm_reference under autograd on
    the card, on kernels/sddmm.py::launch_shape's tiles and on the
    smallest tiles (SDDMM_ROUTES): adv's b1024 batch in 16,512 node slots at bench widths (f
    7, ef 6, its own vocab), f 27 and f 32 with 64 random vocab ids (the
    wide bucket; ef 32 at f 32), mf 13 at nf 10, a ragged batch (single
    atoms, padded edges, a padded graph slot), b16, 32,896 slots, and hub
    nodes of 400 and 5,000 real edges (the latter over 157 tiles).
    Every case has a nonzero aprime[0] and random h and cotangent rows at
    the dummy node, where the padded edges end: out within rtol 1e-4 / atol
    1e-5, the five gradients each divided by its max abs, the same bits in
    a second run; the dummy row's message and gradient must not be zero
    where the batch has padded edges."""
    import torch
    from mpnn_tpu_torch.kernels import sddmm as D
    gen = torch.Generator().manual_seed(87)
    b1024, b16, big, ragged = _dec_check_batches(device)
    cases = [("batch1024", b1024, 7, None, None, None, "rule", 0),
             ("batch1024", b1024, 7, None, None, None, "small tiles", 0),
             ("batch1024", b1024, 27, 64, None, None, "rule", 0),
             ("batch1024", b1024, 27, 64, None, None, "small tiles", 0),
             ("batch1024", b1024, 32, 64, None, 32, "rule", 0),
             ("batch1024", b1024, 10, 9, 13, None, "rule", 0),
             ("batch1024 hub", b1024, 7, None, None, None, "rule", 400),
             ("batch1024 hub", b1024, 7, None, None, None, "small tiles",
              400),
             ("ragged", ragged, 7, None, None, None, "rule", 0),
             ("ragged", ragged, 27, 64, None, None, "rule", 0),
             ("batch16", b16, 7, None, None, None, "rule", 0),
             ("batch16", b16, 7, None, None, None, "small tiles", 0),
             ("batch16", b16, 27, 64, None, None, "rule", 0),
             ("batch2560", big, 7, None, None, None, "rule", 0),
             ("batch2560 hub", big, 7, None, None, None, "small tiles",
              5000)]
    worst = dict.fromkeys(SDDMM_KERNELS, 0.0)
    results, failed, sinks = [], [], 0
    for what, tb, f, k, mf, ef, route, hub in cases:
        c = _sddmm_case(tb, f, k, gen, device, mf=mf, ef=ef)
        if hub:
            c = _hub_case(c, tb, hub, gen)
        with _sddmm_route(**SDDMM_ROUTES[route]):
            tags = [D.device_shape(d, c[5].shape[0], c[0].shape[1],
                                   c[0].shape[2], c[0].shape[0],
                                   device).tag() for d in ("fwd", "bwd")]
            runs, counts = [], []
            for _ in range(2):
                D.reset_launch_counts()
                runs.append(sddmm_value_and_grads(D.sddmm, *c))
                torch.cuda.synchronize()
                counts.append(dict(D.launch_counts))
        got = runs[0]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        want = sddmm_value_and_grads(
            lambda *x: D.sddmm_reference(*x[:8]), *c)
        ok_o, err_o, _ = _within(got[0], want[0])
        ok_g, err_g = True, 0.0
        for x, w in zip(got[1:], want[1:]):
            ok_x, e_x, _ = _scaled_within(x, w)
            ok_g, err_g = ok_g and ok_x, max(err_g, e_x)
        pads = int((tb["edge_mask"] == 0).sum())
        sink = (not pads or (bool(got[0][-1].abs().max() > 0)
                             and bool(got[5][-1].abs().max() > 0)))
        sinks += bool(pads)
        ok = (ok_o and ok_g and sink and same
              and counts == [{"sddmm_fwd": 1, "sddmm_bwd": 1}] * 2
              and all(bool(torch.isfinite(x).all()) for x in got))
        worst["sddmm_fwd"] = max(worst["sddmm_fwd"], err_o)
        worst["sddmm_bwd"] = max(worst["sddmm_bwd"], err_g)
        results.append(
            f"{what} nf={f} mf={c[0].shape[1]} ef={c[1].shape[1]} "
            f"K={c[0].shape[0]} (nodes {int(tb['node_mask'].sum())}/"
            f"{tb['node_mask'].shape[0]} slots, edges "
            f"{int(tb['edge_mask'].sum())}/{tb['edge_src'].shape[0]}, "
            f"{pads} at the dummy node; {route}: {tags[0]} / {tags[1]}): "
            f"out max_abs={err_o:.3e} grads max_scaled={err_g:.3e}, same "
            f"bits {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{what} nf={f} {route}: {counts}, dummy row "
                          f"{sink}, same bits {same}")
    if not sinks:
        failed.append("no case had padded edges")
    if {c[6] for c in cases} != set(SDDMM_ROUTES):
        failed.append("a tile size of SDDMM_ROUTES was not run")
    print(f"sddmm-kernel-check: sddmm_fwd and sddmm_bwd vs sddmm_reference "
          f"under autograd (rtol {RTOL} atol {ATOL}; the gradients of "
          f"aprime, evocab, wa, ba and h divided by their max abs; 1 + 1 "
          f"launches a run, two runs a case; aprime[0], h and gout random "
          f"at the dummy node): " + "; ".join(results), flush=True)
    if failed:
        raise RuntimeError(f"the SDDMM kernels disagree with their plain "
                           f"version: {failed}")
    return worst


def phase_dec_att_train(device):
    """The attention models' decomposed training path on the card, each
    run's launch counts set to 0 just before it and read just after,
    against the design: adv and att through the `train --spmm kernel` verb
    (1 epoch at 16: per step and message network one sddmm_fwd, one
    sddmm_bwd, the edge-MLP chain's 1 + 1 — adv computes its shared
    network's messages once a step, att its three networks' — and one
    set2vec_fwd and set2vec_bwd; per validation and test batch the eval
    kernels: the model's message kernel, set2vec_fwd and the chain's
    forwards, no SDDMM launch), then trainer.train(fuse_step=False), and
    att at the wide phase's afm 27 (f 27, the wide buckets). Each: the
    first 3 losses against the plain path (rtol 1e-3) and the first
    step's parameter gradients (1e-4 / 1e-5, scaled)."""
    import dataclasses
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.train.split import train_test_split
    os.makedirs(OUT_DIR, exist_ok=True)
    lines = []

    def split(gs):
        tr, te = train_test_split(gs, 0.1, 317)
        tr, va = train_test_split(tr, 0.1, 317)
        return tr, va, te

    def n_batches(gs, bs):
        return -(-len(gs) // bs)

    def want(model, nets, n_steps, n_evals):
        return {"sddmm_fwd": nets * n_steps, "sddmm_bwd": nets * n_steps,
                "set2vec_fwd": n_steps + n_evals, "set2vec_bwd": n_steps,
                ATT_MODELS[model][1][0]: n_evals,
                "edge_mlp_fwd": nets * (n_steps + n_evals),
                "edge_mlp_bwd": nets * n_steps}

    def fresh(name):
        log = os.path.join(OUT_DIR, f"dec_att_{name}.jsonl")
        if os.path.exists(log):
            os.remove(log)
        return log

    for model in ("adv", "att"):
        exp = experiments.get(ATT_MODELS[model][0])
        csv = _ps_csv(f"dec_{model}", TRAIN_ROWS)
        gs = G.load_classification_dataset(csv, "smiles", "target")[0]
        tr, va, te = split(gs)
        cfg = zoo.build(model, afm=int(gs[0].afm.shape[-1]),
                        bfm=int(gs[0].bfm.shape[-1]), n_out=PS_CLASSES)
        nets, bs = _nets(cfg.mpnn), exp.train.batch_size
        tcfg = dataclasses.replace(exp.train, fuse_step=False)
        # 1. the verb
        log = fresh(f"{model}_verb")
        steps, epochs, wall = _dec_run(f"dec-att-train {model} verb", argv=[
            "train", "--experiment", exp.name, "--data", csv, "--epochs",
            "1", "--log", log, "--spmm", "kernel"])
        counts = _dec_take(f"dec-att-train {model} verb", want(
            model, nets, n_batches(tr, bs),
            n_batches(va, bs) + n_batches(te, bs)))
        rel, gerr, perr = _dec_first_steps(
            f"dec-att-train {model} verb", cfg, tcfg, tr, device, steps)
        lines.append(
            f"`train --spmm kernel` {exp.name} ({len(tr)} train molecules, "
            f"batch {bs}, 1 epoch, {nets} message network(s)): "
            f"{len(steps)} steps in {wall:.2f} s wall, launches {counts}; "
            f"first 3 losses vs plain max rel {rel:.2e}, first-step "
            f"gradients max_scaled {gerr:.3e} from float64 (plain float32 "
            f"{perr:.3e}); val_loss "
            f"{[round(r['val_loss'], 5) for r in epochs]}")
        # 2. the API
        log = fresh(f"{model}_api")
        acfg = dataclasses.replace(tcfg, epochs=1, log_path=log)
        steps, epochs, wall = _dec_run(f"dec-att-train {model} api",
                                       api=(cfg, acfg, tr, va))
        counts = _dec_take(f"dec-att-train {model} api", want(
            model, nets, n_batches(tr, bs), n_batches(va, bs)))
        rel, gerr, perr = _dec_first_steps(
            f"dec-att-train {model} api", cfg, acfg, tr, device, steps)
        lines.append(
            f"trainer.train(fuse_step=False) {model}: {len(steps)} steps in "
            f"{wall:.2f} s wall, launches {counts}; first 3 losses vs plain "
            f"max rel {rel:.2e}, first-step gradients max_scaled "
            f"{gerr:.3e} from float64 (plain float32 {perr:.3e})")
    # 3. att at the wide widths (afm 27: the SDDMM's and set2vec's wide
    #    buckets)
    exp = experiments.get("att_classification")
    wcsv = _wide_csv("dec_att", "ce", "target")
    wgs = G.load_classification_dataset(wcsv, "smiles", "target")[0]
    wtr, wva, _ = split(wgs)
    wcfg = zoo.build("att", afm=int(wgs[0].afm.shape[-1]),
                     bfm=int(wgs[0].bfm.shape[-1]), n_out=PS_CLASSES)
    bs = exp.train.batch_size
    acfg = dataclasses.replace(exp.train, epochs=1, fuse_step=False,
                               log_path=fresh("att_wide"))
    steps, epochs, wall = _dec_run("dec-att-train wide", api=(
        wcfg, acfg, wtr, wva))
    counts = _dec_take("dec-att-train wide", want(
        "att", _nets(wcfg.mpnn), n_batches(wtr, bs), n_batches(wva, bs)))
    rel, gerr, perr = _dec_first_steps(
        "dec-att-train wide", wcfg, acfg, wtr, device, steps)
    lines.append(
        f"wide att (f {wcfg.mpnn.node_features}, ef "
        f"{wcfg.mpnn.edge_features}; trainer.train): {len(steps)} steps in "
        f"{wall:.2f} s wall, launches {counts}; first 3 losses vs plain "
        f"max rel {rel:.2e}, first-step gradients max_scaled {gerr:.3e} "
        f"from float64 (plain float32 {perr:.3e})")
    print("dec-att-train: " + "; ".join(lines), flush=True)


def _sddmm_bounds(n, e, k, f, ef, mf=None):
    """Least times of the SDDMM kernels' work: the larger of the float32
    operations over the peak CUDA-core rate and the bytes of the
    function's own inputs and outputs (each read or written once) over
    HBM bandwidth, on n real node rows and e real edges. The forward per
    edge: the logits' (nf + ef)·nf FMAs and bias, the softmax (max, sub,
    exp, sum, div: 5 nf), the gating, the GEMV with aprime[vid] and the
    sum into out; reading h, aprime, evocab, wa, ba and vid/src/dst,
    writing out. The backward per edge: the forward's gate again, dg =
    aprimeᵀ·gout, the softmax VJP, the gradient of the concatenated input
    through wa (dh's destination half and devocab), the outer products of
    d aprime and d wa, dba and dh's source half; reading the forward's
    inputs and gout, writing the five gradients."""
    mf = f if mf is None else mf
    gate = 2 * (f + ef) * f + f + 5 * f
    fwd_ops = e * (gate + f + 2 * mf * f + mf)
    bwd_ops = e * (gate + f + 2 * mf * f + 6 * f + 2 * (f + ef) * f
                   + 2 * mf * f + 2 * (f + ef) * f + 2 * f)
    weights = k * mf * f + k * ef + (f + ef) * f + f
    fwd_bytes = 4 * (n * f + weights + 3 * e + n * mf)
    bwd_bytes = 4 * (n * f + weights + 3 * e + n * mf + weights + n * f)
    out = {}
    for name, ops, nbytes in (("sddmm_fwd", fwd_ops, fwd_bytes),
                              ("sddmm_bwd", bwd_ops, bwd_bytes)):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def _sddmm_inputs(net, tb):
    """The SDDMM's inputs as the model's first message network gives them
    on a device batch (models/sparse.py::sparse_att_edge_network): aprime
    from the edge-MLP chain's vocab rows through the final layer (bias
    kept), the vocab's bond rows, attn's weight in the (in, out) layout,
    h0; and the index plan."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    from mpnn_tpu_torch.models.sparse import _edge_penultimates, final_weights
    cfg = net.mpnn.cfg
    mp = net.mpnn.message[0]
    with torch.no_grad():
        ef = tb["edge_feats"] * tb["edge_mask"][:, None]
        _, pen_vocab = _edge_penultimates(mp, ef, cfg, tb["edge_vfirst"])
        wf, bf = final_weights(mp, cfg.node_features, cfg.message_features)
        aprime = (torch.einsum("kp,pmf->kmf", pen_vocab, wf) + bf)
        evocab = ef[tb["edge_vfirst"].long()]
        h0 = tb["node_feats"] * tb["node_mask"]
    return ([t.contiguous() for t in (aprime, evocab, mp.attn.weight.t(),
                                      mp.attn.bias, h0)]
            + [tb["edge_vid"], tb["edge_src"], tb["edge_dst"]],
            plan_from_batch(tb))


def _sddmm_phases(p, direction):
    """The SDDMM kernels' clock64 stamps (cycles) as phases: the forward's
    block 0 (its tile), the backward's block 0 setup (the nonempty ids),
    its first vocab and first node tile (a tile's indices include staging
    the tables) and the last sums (kernels/sddmm.py::PROF_SLOTS)."""
    if direction == "fwd":
        return {"tables and indices": p[1] - p[0], "rows": p[2] - p[1],
                "compute": p[3] - p[2], "row sums and combine": p[4] - p[3],
                "total": p[5] - p[0]}
    vocab = {"indices": p[1] - p[0], "rows": p[2] - p[1],
             "compute": p[3] - p[2], "dots": p[4] - p[3]}
    if p[5]:
        vocab["combine"] = p[5] - p[4]
    return {"setup": p[21] - p[20], "vocab tile": vocab,
            "node tile": {"indices": p[9] - p[8], "rows": p[10] - p[9],
                          "compute": p[11] - p[10],
                          "row sums and combine": p[12] - p[11]},
            "last sums": p[17] - p[16]}


def _sddmm_detail(pf, pb, prep_f, prep_b, device):
    """The empty-kernel floors (the same grid and combines with no
    arithmetic: CUDA events over 100 launches, and the device time a launch
    in a trace of 20) and one launch's clock64 phases of the prepared
    forward and backward; prep_*(**kw) prepares another launch on the same
    inputs. Leaves the launch counts as they were."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import sddmm as D
    floors, phases = {}, {}
    counts = dict(D.launch_counts)
    for name, prep in (("sddmm_fwd", prep_f), ("sddmm_bwd", prep_b)):
        fl = prep(floor=True)
        floors[name] = (_events_ms(lambda: K.launch_prepared(fl), 100),
                        _kernel_trace_us_n(20, fl)[0] / 20 / 1e3)
        prof = torch.zeros(D.PROF_SLOTS, dtype=torch.int64, device=device)
        K.launch_prepared(prep(prof=prof))
        torch.cuda.synchronize()
        phases[name] = _sddmm_phases(prof.tolist(), name[-3:])
    D.launch_counts.update(counts)
    return floors, phases


def _sddmm_times(net, b, tb, gen, device):
    """Both SDDMM kernels on adv's first message network's inputs on one
    batch: CUDA events over 100 back-to-back launches (`ms`, as every row),
    the device time a launch in a trace of 20, the plain version's time
    (autograd through it for the backward), the bound, the route, the
    empty-kernel floor, one launch's clock64 phases, and each kernel on the
    real edges alone (the padded edges all end at the dummy node).
    Returns ({kernel: record}, text)."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_fused_eval
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import sddmm as D
    args, plan = _sddmm_inputs(net, tb)
    n, f = args[4].shape
    k, mf = args[0].shape[:2]
    ef, e = args[1].shape[1], args[5].shape[0]
    bs = int(b["graph_mask"].shape[0])
    g = torch.randn(n, mf, generator=gen).to(device)
    order, ptr = plan.edge_order, plan.dst_ptr
    er = int(b["edge_mask"].sum())
    with torch.no_grad():
        prep_f = lambda **kw: D.prepare_sddmm_fwd(*args, order, ptr, **kw)
        prep_b = lambda **kw: D.prepare_sddmm_bwd(*args[:5], g, *args[5:],
                                                  **kw)
        pf, pb = prep_f(), prep_b()
        ms = {p.name: _events_ms(lambda p=p: K.launch_prepared(p), 100)
              for p in (pf, pb)}
        trace = dict(zip(("sddmm_fwd", "sddmm_bwd"),
                         (t / 20 for t in _kernel_trace_us_n(20, pf, pb))))
        rp = [torch.as_tensor(x, device=device) for x in plan_fused_eval(
            b["edge_dst"][:er], b["node_graph"], bs)]
        real = [a[:er].contiguous() for a in args[5:]]
        pr = (D.prepare_sddmm_fwd(*args[:5], *real, rp[0], rp[1]),
              D.prepare_sddmm_bwd(*args[:5], g, *real))
        real_ms = {p.name: _events_ms(lambda p=p: K.launch_prepared(p), 100)
                   for p in pr}
        floors, phases = _sddmm_detail(pf, pb, prep_f, prep_b, device)
        plain = {"sddmm_fwd": _events_ms(
            lambda: D.sddmm_reference(*args), 20)}
    leaves = [x.detach().requires_grad_() for x in args[:5]]
    obj = (D.sddmm_reference(*leaves, *args[5:]) * g).sum()
    plain["sddmm_bwd"] = _events_ms(lambda: torch.autograd.grad(
        obj, leaves, retain_graph=True), 20)
    bounds = _sddmm_bounds(float(b["node_mask"].sum()), float(er), k, f,
                           ef, mf)
    rec, parts = {}, []
    for name in SDDMM_KERNELS:
        shape = D.device_shape(name[-3:], e, mf, f, k, device)
        rec[name] = dict(ms=ms[name], trace_ms=trace[name] / 1e3,
                         plain_ms=plain[name], bound_ms=bounds[name][0],
                         bound_by=bounds[name][1], floor_ms=floors[name],
                         real_ms=real_ms[name], route=shape.tag(),
                         phases=phases[name])
        parts.append(
            f"{name} {ms[name] * 1e3:.2f} us (events, 100 launches; trace "
            f"{trace[name]:.2f} us), plain {plain[name] * 1e3:.1f} us, bound "
            f"{bounds[name][0] * 1e3:.3f} us by {bounds[name][1]} "
            f"({bounds[name][2] / 1e6:.3f} Mop, {bounds[name][3] / 1e6:.3f} "
            f"MB), route {shape.tag()}, empty-kernel floor "
            f"{floors[name][0] * 1e3:.2f} us (trace "
            f"{floors[name][1] * 1e3:.2f} us), on the {er} real edges alone "
            f"{real_ms[name] * 1e3:.2f} us, clock64 cycles "
            f"{json.dumps(phases[name])}")
    text = (f"SDDMM (K {k}, nf {f}, mf {mf}, ef {ef}; {e - er} padded edges "
            f"at the dummy node): " + ", ".join(parts))
    return rec, text


def phase_dec_att_times(device, card):
    """The decomposed adv and att train steps (the SDDMM, set2vec and
    edge-MLP kernels; host clock ending in the loss read-back) at batch
    16 and 1024 beside the whole-step path's on the same batch and
    weights, in turns (whole, decomposed, decomposed, whole); at b1024
    the decomposed step's device busy time, device ops and idle share
    from a trace, and at both batches each SDDMM kernel's time on adv's
    first step's own inputs (_sddmm_times)."""
    import statistics
    import torch
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (TrainConfig, batch_to_device,
                                              decomposed_hooks, train_step)
    gen = torch.Generator().manual_seed(89)
    out, lines = {}, []
    for bs in DEC_ATT_BATCHES:
        b = _batch((SMILES * (bs // len(SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randint(0, PS_CLASSES, (bs,), generator=gen
                                    ).numpy()
        tb = batch_to_device(b, device)
        out[bs] = {}
        for model in ("adv", "att"):
            cfg = zoo.build(model, afm=b["node_feats"].shape[1],
                            bfm=b["edge_feats"].shape[1], n_out=PS_CLASSES)
            net = network_init(cfg, gen, device)
            opt = adam(net.parameters(), 1e-3)
            hooks = decomposed_hooks(cfg, TrainConfig(fuse_step=False))
            reps = 20 if bs <= 16 else 10

            def timed(fused):
                kw = dict(loss_kind="ce", hooks=None if fused else hooks)
                for _ in range(3):
                    float(train_step(net, opt, tb, **kw))
                lat = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    float(train_step(net, opt, tb, **kw))
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
                return lat
            whole, dec = timed(True), timed(False)
            dec += timed(False)
            whole += timed(True)
            rec = dict(step_ms=statistics.median(dec),
                       whole_ms=statistics.median(whole))
            line = (f"{model} batch {bs} (nodes {int(b['node_mask'].sum())}/"
                    f"{b['node_mask'].shape[0]}, edges "
                    f"{int(b['edge_mask'].sum())}/{b['edge_src'].shape[0]}"
                    f"): decomposed train step median {rec['step_ms']:.3f} "
                    f"ms mean {statistics.fmean(dec):.3f} ms, whole-step "
                    f"median {rec['whole_ms']:.3f} ms mean "
                    f"{statistics.fmean(whole):.3f} ms ({2 * reps} reps "
                    f"each, in turns, loss read back)")
            if bs == DEC_ATT_BATCHES[-1]:
                busy, traced = _dec_trace(
                    model, lambda: train_step(net, opt, tb, loss_kind="ce",
                                              hooks=hooks),
                    SDDMM_KERNELS + ATT_KERNELS[2:] + MLP_KERNELS,
                    rec["step_ms"])
                rec["busy_us"] = busy
                line += "; " + traced
            if model == "adv":
                sd, text = _sddmm_times(net, b, tb, gen, device)
                out[bs].update(sd)
                line += "; " + text
            out[bs][model] = rec
            lines.append(line)
    print(f"dec-att-times [{card}]: " + "; ".join(lines), flush=True)
    return out


# ---------------------------------------------------------------------------
# the split training backward (kernels/split_bwd.py): ro_bwd, msg_bwd and
# ps_walk_bwd, with recurrence_bwd between them for the shared family
# ---------------------------------------------------------------------------

SPLIT_KERNELS = ("ro_bwd", "msg_bwd", "ps_walk_bwd")
# their launches on the main paths (split-train), summed
SPLIT_MAIN = dict.fromkeys(SPLIT_KERNELS, 0)
SPLIT_BATCH = 3584
# the node slots of split-kernel-check's b3584 batch: 16.125 a molecule,
# as the serving path's 16,512 at b1024
SPLIT_NODES = 57856


def _noisy(t, pad, gen):
    """A copy of t (·, N, f) with random values at the padded node slots
    `pad` (the dummy node among them): the kernels must give what the
    function gives there, which masks them out."""
    import torch
    t = t.detach().clone()
    idx = (slice(None),) * (t.dim() - 2) + (pad,)
    t[idx] = torch.randn(t[idx].shape, generator=gen).to(t.device)
    return t


def split_kernel_case(tb, f, od, steps, mn, sn, gen, device, k=None):
    """Each split-backward kernel through its wrapper against its plain
    version on one batch: the per-step family's weights at widths f, od
    and `steps` message networks (_ps_case; with k, k random vocab ids on
    the real edges), the forward's residuals from the plain forward, and
    random cotangents; h0, h_T's slot, gh and dm random at the padded node
    slots. Returns {kernel: (ok, max error of its outputs each divided by
    its max abs)}."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import msg_bwd as MB
    from mpnn_tpu_torch.kernels import psteps_walk as PW
    from mpnn_tpu_torch.kernels import readout_bwd as RB
    c, _ = _ps_case(tb, f, od, gen, device, steps=steps)
    if k is not None:
        rnd = torch.randint(1, k, c["vid"].shape, generator=gen,
                            dtype=torch.int32).to(device)
        c["vid"] = torch.where(tb["edge_mask"] > 0, rnd,
                               torch.zeros_like(rnd)).contiguous()
        c["amat"] = 0.2 * torch.randn(steps, k, f, f, generator=gen).to(
            device)
    weights, meta = P.flat_weights(
        c["amat"], c["a0"], c["mbias"], c["gru"], c["ma_bns"], c["bns"],
        c["ro"], c["h0"], steps=steps, msg_norm=mn, state_norm=sn)
    weights = [(name, t.detach()) for name, t in weights]
    w = dict(weights)
    mask, ng, plan = c["mask"], c["node_graph"], c["plan"]
    pad = mask[:, 0] == 0
    T = steps
    with torch.no_grad():
        _, out, stats, htil = P._reference_residuals(
            weights, c["h0"].detach(), mask, ng, c["labels"], c["gmask"],
            c["vid"], c["src"], c["dst"], plan, meta)
        h0 = _noisy(c["h0"], pad, gen)
        gout = torch.randn(out.shape, generator=gen).to(device)
        gl = torch.randn(1, generator=gen).to(device)
        ro = {s: {"w": w[f"ro_{s}w"], "b": w[f"ro_{s}b"]} for s in "ij"}
        ro_in = (_noisy(htil[2 * T - 1], pad, gen), stats[2 * T - 1],
                 w["bn_w"][T - 1], w["bn_b"][T - 1], h0, mask, ng, ro,
                 c["labels"], c["gmask"], out, gout, gl)
        gh = _noisy(torch.randn(h0.shape, generator=gen).to(device), pad,
                    gen)
        dm = torch.randn(T, *h0.shape, generator=gen).to(device)
        runs = {
            "ro_bwd": lambda fn: fn(*ro_in, state_norm=sn),
            "ps_walk_bwd": lambda fn: fn(gh, h0, mask, htil, stats,
                                         plan.graph_node_ptr, weights,
                                         steps=T, msg_norm=mn,
                                         state_norm=sn),
            "msg_bwd": lambda fn: fn(w["amat"], w["a0"], h0, mask, ng,
                                     c["vid"], c["src"], c["dst"], dm,
                                     plan)}
        plain = {
            "ro_bwd": lambda *a, **kw: RB.ro_bwd_reference(*a, **kw),
            "ps_walk_bwd": lambda gh_, h0_, mask_, htil_, st_, ptr_, wt, **kw:
                PW.ps_walk_bwd_reference(gh_, h0_, mask_, htil_, dict(wt),
                                         **kw),
            "msg_bwd": lambda *a: MB.msg_bwd_reference(
                *a[:-1], a[-1].graph_node_ptr.shape[0] - 1)}
        fns = {"ro_bwd": RB.ro_bwd, "ps_walk_bwd": PW.ps_walk_bwd,
               "msg_bwd": MB.msg_bwd}
        res = {}
        for name, run in runs.items():
            got = _flat_tensors(run(fns[name]))
            _sync(device)
            want = _flat_tensors(run(plain[name]))
            ok, err = True, 0.0
            for a, b in zip(got, want):
                o, e, _ = _scaled_within(a, b)
                ok = ok and o and bool(torch.isfinite(a).all())
                err = max(err, e)
            res[name] = (ok and len(got) == len(want), err)
    return res


def _flat_tensors(x):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    import torch
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for v in x for t in _flat_tensors(v)]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def _split_check_batches(device):
    """split-kernel-check's device batches: b1024 in 16,512 node slots,
    b3584 in SPLIT_NODES, b16 and the ragged batch."""
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.graphs.batching import attach_fused_plan
    from mpnn_tpu_torch.train.trainer import batch_to_device
    b1024, b16, _, ragged = _dec_check_batches(device)
    gs, _ = G.encode_molgraphs(G.generate_molgraphs(
        (SMILES * 359)[:SPLIT_BATCH], [0.0] * SPLIT_BATCH))
    big = batch_to_device(attach_fused_plan(G.attach_edge_vocab(
        G.collate_packed(gs, node_cap=SPLIT_NODES).as_dict(), vocab_cap=8)),
        device)
    return b1024, big, b16, ragged


def phase_split_kernel_check(device):
    """The split backward's three kernels against their plain versions on
    the card: at b1024 (16,512 slots) and b3584 (57,856 slots) for lipo's
    widths (f 10, od 14, one message network; state bn1d) and the
    per-step family's (f 8, od 16, T 3) with every msg × state norm pair,
    graph_norm's (f 7, od 28), the wide bucket (f 27 and 32, od 108 and
    128, 64 vocab ids), a ragged batch and b16; every case with h0, h_T's
    slot, gh and dm random at the padded node slots (the dummy node's
    among them). Each output divided by its max abs, rtol 1e-4 / atol
    1e-5."""
    import torch
    gen = torch.Generator().manual_seed(101)
    b1024, big, b16, ragged = _split_check_batches(device)
    cases = ([("b1024 lipo", b1024, 10, 14, 1, "bn1d", "bn1d", None),
              ("b3584 lipo", big, 10, 14, 1, "bn1d", "bn1d", None)]
             + [("b3584 encoded", big, 8, 16, 3, mn, sn, None)
                for mn, sn in PS_NORMS]
             + [("b1024 encoded", b1024, 8, 16, 3, "bn1d", "bn1d", None),
                ("b3584 graph_norm", big, 7, 28, 3, "none", "stateless",
                 None),
                ("b1024 wide", b1024, 27, 108, 3, "bn1d", "bn1d", 64),
                ("b3584 wide", big, 32, 128, 3, "none", "stateless", 64),
                ("b1024 wide lipo", b1024, 30, 60, 1, "bn1d", "bn1d", 64),
                ("ragged", ragged, 8, 16, 3, "bn1d", "bn1d", None),
                ("ragged T 1", ragged, 10, 14, 1, "bn1d", "bn1d", None),
                ("b16", b16, 8, 16, 3, "bn1d", "stateless", None)])
    worst = dict.fromkeys(SPLIT_KERNELS, 0.0)
    results, failed = [], []
    for what, tb, f, od, T, mn, sn, k in cases:
        res = split_kernel_case(tb, f, od, T, mn, sn, gen, device, k=k)
        for name, (ok, err) in res.items():
            worst[name] = max(worst[name], err)
        ok = all(o for o, _ in res.values())
        results.append(
            f"{what} {mn}/{sn} f={f} od={od} T={T}"
            + (f" K={k}" if k else "") + f" ({tb['node_mask'].shape[0]} "
            f"slots): " + " ".join(f"{n} {e:.2e}" for n, (_, e)
                                   in res.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{what} {mn}/{sn}: {res}")
    # the walks the split's rule sets beside ps_walk_bwd at b3584's 57,856
    # slots: the per-step family's whole backward (forced, every norm
    # pair; blocks past their tile) and lipo's recurrence_bwd (its rule's
    # route and 16-node tiles), each against its plain version
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import recurrence as R
    whole = functools.partial(P.fused_psteps, bwd="whole")
    walks = []
    for mn, sn in PS_NORMS:
        c, leaves = _ps_case(big, 8, 16, gen, device)
        kw = dict(steps=3, msg_norm=mn, state_norm=sn)
        cw = torch.randn(c["labels"].shape[0], 16, generator=gen).to(device)
        got = _step_and_grads(whole, _ps_step_args(c), leaves, cw, kw)
        _sync(device)
        want = _step_and_grads(P.fused_psteps_reference, _ps_step_args(c),
                               leaves, cw, kw)
        _, _, ok, err = _step_errors(got, want, mn)
        walks.append(f"fused_psteps_bwd {mn}/{sn} {err:.2e}"
                     + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"b3584 whole {mn}/{sn}")
    for route in (None, "spilled"):
        args, leaves, g = rec_case(SPLIT_NODES, 10, gen, device)
        with _rec_route(route):
            got = rec_value_and_grads(R.recurrence, args, leaves, g,
                                      DEC_STEPS)
            _sync(device)
            shape = R.device_bwd_shape(SPLIT_NODES, "", DEC_STEPS, device)
        want = rec_value_and_grads(R.reference_recurrence, args, leaves, g,
                                   DEC_STEPS)
        ok, err = True, 0.0
        for k, w in want[1].items():
            ok_k, e_k, _ = _scaled_within(got[1][k], w)
            ok, err = ok and ok_k, max(err, e_k)
        walks.append(f"recurrence_bwd {shape.tag()} {err:.2e}"
                     + ("" if ok else " FAIL"))
        if not ok:
            failed.append(f"b3584 recurrence_bwd {route}")
    results.append(f"b3584 ({SPLIT_NODES} slots) whole walks: "
                   + ", ".join(walks))
    print(f"split-kernel-check: ro_bwd, msg_bwd, ps_walk_bwd vs their plain "
          f"versions (each output divided by its max abs; rtol {RTOL} atol "
          f"{ATOL}; inputs random at the padded slots); fused_psteps_bwd "
          f"and recurrence_bwd beside them: " + "; ".join(results),
          flush=True)
    if failed:
        raise RuntimeError(f"the split backward's kernels disagree with "
                           f"their plain versions: {failed}")
    return worst


SPLIT_ROWS = 9000
# split-times' smaller batch, the split route forced there
SPLIT_SMALL = 1024
# the split-train runs: (experiment, the op's family); encoded_ecfp's
# message bn1d with state none is the one main-path pair without a state
# norm
SPLIT_MODELS = (("lipo", "shared"), ("encoded_classification", "psteps"),
                ("graph_norm_classification", "psteps"),
                ("encoded_ecfp", "psteps"))
# encoded_ecfp's molecules (16,384 float32 bits an atom): its train split
# (~2,430 molecules, ~39k node slots) takes one batch past the split's
# 28,672 slots
SPLIT_ECFP_ROWS = 3000


@contextlib.contextmanager
def _route(bwd):
    """The training ops of models/fused_train.py with their backward route
    forced to `bwd` within the block (the models pass none: 'auto')."""
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models import fused_train as FT
    FT.fused_step = functools.partial(K.fused_step, bwd=bwd)
    FT.fused_psteps = functools.partial(P.fused_psteps, bwd=bwd)
    try:
        yield
    finally:
        FT.fused_step, FT.fused_psteps = K.fused_step, P.fused_psteps


def _split_want(family, route, n_steps, n_evals, nets):
    """The launches of a fused training run: per step one forward and the
    route's backward launches, per eval batch one eval launch, and the
    edge-MLP chain's per message network."""
    fwd, bwd, ev = (("fused_step_fwd", "fused_step_bwd", "fused_eval")
                    if family == "shared" else
                    ("fused_psteps_fwd", "fused_psteps_bwd",
                     "fused_psteps_eval"))
    want = {fwd: n_steps, ev: n_evals, "edge_mlp_fwd": nets * (
        n_steps + n_evals), "edge_mlp_bwd": nets * n_steps}
    if route == "whole":
        want[bwd] = n_steps
    else:
        walk = "recurrence_bwd" if family == "shared" else "ps_walk_bwd"
        want.update(dict.fromkeys(("ro_bwd", "msg_bwd", walk), n_steps))
    return {k: v for k, v in want.items() if v}


def _fused_first_grads(cfg, tcfg, batch, device):
    """The first step's parameter gradients from the trainer's initial
    weights (seed tcfg.seed) on `batch` through the whole-step ops (the
    route their rule picks), the plain model in float32 and the plain
    model in float64 (weights and the batch's floats cast up), under
    PyTorch's deterministic algorithms (_dec_first_grads)."""
    import torch
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train.trainer import batch_loss

    def grads(fused, dtype):
        n = network_init(cfg, torch.Generator().manual_seed(tcfg.seed),
                         device).to(dtype)
        b = {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                 else v) for k, v in batch.items()}
        out, _ = network_apply_packed(n, b, fused=fused, training=True)
        batch_loss(tcfg.loss, out, b).backward()
        return {k: p.grad for k, p in n.named_parameters()
                if p.grad is not None}

    with _deterministic_torch():
        return (grads(True, torch.float32), grads(False, torch.float32),
                grads(False, torch.float64))


def fused_grad_distance(cfg, got, exact):
    """_grad_distance of the leaves of `got` from `exact` (float64), where
    a leaf whose float64 gradient is zero in theory (a bias under a batch
    norm, as the encoders' last layers: below 1e-9 of the largest
    gradient) is held, unscaled, to atol of the largest gradient: its
    distance is its max abs over that."""
    top = max(float(w.abs().max()) for w in exact.values())
    zero = {k for k, w in exact.items() if float(w.abs().max()) <= 1e-9 * top}
    keep = lambda d: {k: v for k, v in d.items() if k not in zero}
    margin, where, worst = _grad_distance(cfg, keep(got), keep(exact))
    for k in zero:
        m_k = float(got[k].abs().max()) / (ATOL * top)
        if m_k >= margin:
            margin, where = m_k, k
    return margin, where, worst


def _split_first_steps(what, cfg, tcfg, train_gs, device, steps):
    """A run's first 3 logged losses against the plain path on the card
    (rtol 1e-3), from the trainer's initial weights on its first shuffled
    batches, and the first step's gradients through the fused ops against
    the plain model in float64 (scaled, 1e-4 / 1e-5; a leaf whose float64
    gradient is zero in theory within atol of the largest gradient).
    Returns (max rel loss difference, the fused ops' max scaled gradient
    distance from float64, the plain float32 model's)."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    loader = G.GraphLoader(train_gs, tcfg.batch_size, shuffle=True,
                           seed=tcfg.seed)
    batches = [batch_to_device(b, device) for b, _ in zip(loader, range(3))]
    net = network_init(cfg, torch.Generator().manual_seed(tcfg.seed),
                       device)
    opt = adam(net.parameters(), tcfg.learning_rate,
               weight_decay=tcfg.weight_decay)
    plain = [float(train_step(net, opt, b, fused=False, loss_kind=tcfg.loss))
             for b in batches]
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if rel > 1e-3:
        raise RuntimeError(f"{what}: first steps {steps[:3]} vs plain path "
                           f"{plain} (rel {rel:.2e} > 1e-3)")
    got, p32, exact = _fused_first_grads(cfg, tcfg, batches[0], device)
    if set(got) != set(exact) or set(p32) != set(exact):
        raise RuntimeError(f"{what}: the paths reach other leaves")
    margin, where, worst = fused_grad_distance(cfg, got, exact)
    p_margin, _, p_worst = fused_grad_distance(cfg, p32, exact)
    if margin > 1:
        raise RuntimeError(f"{what}: first-step gradient of {where}: "
                           f"{margin:.2f} of the tolerance from float64 "
                           f"(max scaled {worst:.3e}; the plain float32 "
                           f"model: {p_margin:.2f}, {p_worst:.3e})")
    return rel, worst, p_worst


def phase_split_train(device):
    """Large-batch training through the split backward, each run's launch
    counts set to 0 just before it and read just after: lipo through
    `train --batch-size 3584` (1 epoch on SPLIT_ROWS of bench.py's
    molecules; the loader's node cap is its worst batch), encoded_
    classification and graph_norm_classification through trainer.train at
    batch 3584 on the same molecules, encoded_ecfp (bn1d/none) through
    trainer.train at batch 3584 on SPLIT_ECFP_ROWS of them with their
    Morgan bits. The node slots of each; the `auto`
    route must split: per step one forward, one ro_bwd, one msg_bwd and
    one recurrence_bwd (lipo) or ps_walk_bwd (the per-step family), no
    whole-step backward. Each run's first 3 losses against the plain path
    (rtol 1e-3) and its first step's gradients against the plain model in
    float64 (rtol 1e-4 / atol 1e-5, scaled). Then one train step of each
    model at b1024 (16,512 slots), which must take the whole route."""
    import dataclasses
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import split_bwd
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.split import train_test_split
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    os.makedirs(OUT_DIR, exist_ok=True)
    bs = SPLIT_BATCH

    def split(gs):
        tr, te = train_test_split(gs, 0.1, 317)
        tr, va = train_test_split(tr, 0.1, 317)
        return tr, va, te

    def n_batches(gs):
        return -(-len(gs) // bs)

    lines = []
    lcsv = _train_csv(SPLIT_ROWS)
    lgs, _ = G.load_number_dataset(lcsv, "smiles", "exp")
    pcsv = _ps_csv("split", SPLIT_ROWS)
    pgs = G.load_classification_dataset(pcsv, "smiles", "target")[0]
    b1024 = _split_check_batches(device)[0]
    for exp_name, family in SPLIT_MODELS:
        exp = experiments.get(exp_name)
        ecfp = exp.task == "ecfp"
        if ecfp:
            gs, ge = G.load_ecfp_dataset(
                _ecfp_csv("split_ecfp", SPLIT_ECFP_ROWS), "smiles", "target")
        else:
            gs = lgs if family == "shared" else pgs
        tr, va, te = split(gs)
        dims = dict(afm=int(gs[0].afm.shape[-1]), bfm=int(gs[0].bfm.shape[-1]),
                    nafm=int(gs[0].nafm.shape[-1]))
        cfg = (zoo.lipo(dims["afm"], dims["bfm"], dims["nafm"])
               if family == "shared" else
               zoo.build(exp.model, afm=ge.atom_width(), bfm=ge.bond_width(),
                         n_out=16384) if ecfp else
               zoo.build(exp.model, **dims, n_out=PS_CLASSES))
        log = os.path.join(OUT_DIR, f"split_train_{exp_name}.jsonl")
        if os.path.exists(log):
            os.remove(log)
        n = G.GraphLoader(tr, bs)._packed_caps[0]
        f = cfg.mpnn.node_features
        T = cfg.mpnn.message_steps
        route = split_bwd.route(family, steps=T, f=f, n=n,
                                msg_norm=cfg.mpnn.msg_norm,
                                state_norm=cfg.mpnn.state_norm)
        if route != "split":
            raise RuntimeError(f"split-train {exp_name}: {n} node slots "
                               f"take the {route} route")
        tcfg = dataclasses.replace(exp.train, epochs=1, batch_size=bs,
                                   log_path=log)
        if family == "shared":
            n_evals = n_batches(va) + n_batches(te)
            steps, epochs, wall = _dec_run(f"split-train {exp_name}", argv=[
                "train", "--experiment", exp_name, "--data", lcsv,
                "--epochs", "1", "--batch-size", str(bs), "--ckpt-dir",
                os.path.join(OUT_DIR, "split_ckpt_lipo"), "--log", log])
            how = "`train --batch-size 3584`"
        else:
            n_evals = n_batches(va)
            steps, epochs, wall = _dec_run(f"split-train {exp_name}",
                                           api=(cfg, tcfg, tr, va))
            how = "trainer.train(batch_size=3584)"
        counts = _dec_take(f"split-train {exp_name}", _split_want(
            family, "split", n_batches(tr), n_evals, _nets(cfg.mpnn)))
        for k in SPLIT_KERNELS:
            SPLIT_MAIN[k] += counts.get(k, 0)
        rel, gerr, perr = _split_first_steps(
            f"split-train {exp_name}", cfg, tcfg, tr, device, steps)
        # one step at b1024: the whole route
        if ecfp:
            loader = G.GraphLoader(tr, SPLIT_SMALL)
            tb = batch_to_device(loader._collate_chunk(
                loader._epoch_chunks()[0]), device)
        else:
            tb = dict(b1024)
        if family == "psteps" and not ecfp:
            tb["labels"] = (torch.arange(tb["labels"].shape[0],
                                         device=device) % PS_CLASSES)
        net = network_init(cfg, torch.Generator().manual_seed(317), device)
        opt = adam(net.parameters(), 1e-4, weight_decay=1e-5)
        _dec_reset()
        loss = float(train_step(net, opt, tb, loss_kind=tcfg.loss))
        torch.cuda.synchronize()
        small = _dec_take(f"split-train {exp_name} b1024", _split_want(
            family, "whole", 1, 0, _nets(cfg.mpnn)))
        if not math.isfinite(loss):
            raise RuntimeError(f"split-train {exp_name} b1024: loss {loss}")
        lines.append(
            f"{exp_name} ({how}, T {T}, f {f}; {len(tr)} train molecules in "
            f"{n} node slots): {len(steps)} steps in {wall:.2f} s wall, "
            f"launches {counts}; first 3 losses vs plain max rel {rel:.2e}, "
            f"first-step gradients max_scaled {gerr:.3e} from float64 "
            f"(plain float32 {perr:.3e}); val_loss "
            f"{[round(r['val_loss'], 5) for r in epochs]}; at b1024 "
            f"({tb['node_mask'].shape[0]} slots) one step takes the "
            f"whole route: {small}")
        del tb
    print("split-train: " + "; ".join(lines), flush=True)


def _split_bounds(b, f, od, k, T, msg_norm, state_norm):
    """Least times of the split backward's kernels on this batch, each the
    larger of its float32 operations over the peak CUDA-core rate and its
    bytes (each input read once, each output written once) over HBM
    bandwidth; real nodes and edges. ro_bwd: rebuilding h_T, the logits
    and values (2·2·2f·od a node), the softmax VJP, gh and dh0 (2·2·2f·od)
    and the weight gradients' outer products (2·2·2f·od); msg_bwd: per
    edge and network Aᵀ·dm and dm ⊗ h0 (2·2f²), per node and network the
    graph sums and A0ᵀ·D, per graph dA0; ps_walk_bwd: per node and step
    the replayed gates (2 GEMVs of f → 3f), their transposes and outer
    products, the gate math and each norm in the modes present and its
    VJP."""
    nr = float(b["node_mask"].sum())
    er = float(b["edge_mask"].sum())
    n = float(b["node_mask"].shape[0])
    g = float(b["graph_mask"].shape[0])
    gemv = 2 * f * 3 * f
    norms = 20 * f * ((msg_norm != "none") + (state_norm != "none"))
    ro_w = 4 * f * od + 2 * od
    gru_w = 6 * f * f + 6 * f + 4 * T * f
    work = {
        "ro_bwd": (nr * (3 * 2 * 2 * 2 * f * od + 12 * od + 3 * f),
                   4 * (2 * nr * f + 2 * n + 4 * f + 2 * g + 2 * g * od + 1
                        + 2 * nr * f + 2 * ro_w)),
        "msg_bwd": (er * T * 4 * f * f + nr * T * (2 * f * f + f) + nr * f
                    + g * T * 2 * f * f,
                    4 * (T * nr * f + nr * f + 2 * n + 3 * er + g
                         + n * f + 2 * T * (k * f * f + f * f) + T * f)),
        "ps_walk_bwd": (T * nr * (6 * gemv + 15 * f + norms),
                        4 * (2 * nr * f + 2 * T * nr * f + 4 * T * f
                             + nr * f + T * nr * f + 2 * gru_w))}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", ops,
                     nbytes)
    return out


def _split_launches(family, net, tb, gen):
    """The split route's prepared kernel launches on the inputs the main
    path gives them at this batch (the forward kernel run once for its
    residuals), the whole route's backward launch, and the plain versions
    as callables: ({name: PreparedLaunch}, {name: plain callable})."""
    import torch
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.kernels import msg_bwd as MB
    from mpnn_tpu_torch.kernels import psteps_walk as PW
    from mpnn_tpu_torch.kernels import readout_bwd as RB
    from mpnn_tpu_torch.kernels import recurrence as R
    from mpnn_tpu_torch.models.fused_train import (fused_psteps_args,
                                                   fused_step_args)
    from mpnn_tpu_torch.models.network import mpnn_input
    det = lambda x: ({k: det(v) for k, v in x.items()}
                     if isinstance(x, dict) else
                     [det(v) for v in x] if isinstance(x, list) else
                     x.detach() if isinstance(x, torch.Tensor) else x)
    labels = tb["labels"].float()
    with torch.no_grad():
        mb, _ = mpnn_input(net, tb, training=True)
        if family == "shared":
            args, kw = fused_step_args(net.mpnn, mb, labels)
        else:
            (args, kw), _ = fused_psteps_args(net.mpnn, mb, labels)
    (amat, a0, mbias, h0, mask, ng, gru, ma, bnp, ro, labels, gmask, vid,
     src, dst, plan) = [det(a) for a in args]
    T = kw["steps"]
    if family == "shared":
        weights = K._flat_weights(amat, a0, mbias, gru, ma, bnp, ro)
        meta = K.StepMeta(T, 1, 1, 1)
        fwd = K.prepare_fused_step_fwd(weights, h0, mask, ng, labels, gmask,
                                       vid, src, dst, plan, meta)
    else:
        weights, meta = P.flat_weights(amat, a0, mbias, gru, ma, bnp, ro, h0,
                                       **kw)
        fwd = P.prepare_fused_psteps_fwd(weights, h0, mask, ng, labels,
                                         gmask, vid, src, dst, plan, meta)
    _, out, stats, htil = K.launch_prepared(fwd)
    w = dict(weights)
    gout = torch.randn(out.shape, generator=gen).to(out.device)
    gl = torch.ones(1, device=out.device)
    last = T if family == "shared" else 2 * T - 1
    sn = kw["state_norm"]
    nw, nb = ((w["bn_w"], w["bn_b"]) if family == "shared"
              else (w["bn_w"][T - 1], w["bn_b"][T - 1]))
    ro_in = (htil[last], stats[last], nw, nb, h0, mask, ng, ro, labels,
             gmask, out, gout, gl)
    prep = {"ro_bwd": RB.prepare_ro_bwd(*ro_in, state_norm=sn)}
    plain = {"ro_bwd": lambda: RB.ro_bwd_reference(*ro_in, state_norm=sn)}
    gh = K.launch_prepared(prep["ro_bwd"])[0].clone()
    a3 = amat if family == "psteps" else amat[None]
    b3 = a0 if family == "psteps" else a0[None]
    if family == "shared":
        rw = [t.contiguous() for t in R._flat(gru, ma, bnp)]
        prep["recurrence_bwd"] = R.prepare_recurrence_bwd(
            htil[0], h0, mask, rw, stats, htil[1:], gh, steps=T)
        plain["recurrence_bwd"] = lambda: R.recurrence_vjp_reference(
            htil[0], h0, mask, gru, ma, bnp, gh, steps=T)
        dmsgs = K.launch_prepared(prep["recurrence_bwd"])[0][None].clone()
        prep["fused_step_bwd"] = K.prepare_fused_step_bwd(
            weights, h0, labels, gmask, out, gout, gl, htil, stats, ng, vid,
            src, dst, plan, meta._replace(split=0))
    else:
        walk_kw = dict(steps=T, msg_norm=kw["msg_norm"], state_norm=sn)
        prep["ps_walk_bwd"] = PW.prepare_ps_walk_bwd(
            weights, gh, h0, htil, stats, plan.graph_node_ptr, **walk_kw)
        plain["ps_walk_bwd"] = lambda: PW.ps_walk_bwd_reference(
            gh, h0, mask, htil, w, **walk_kw)
        dmsgs = K.launch_prepared(prep["ps_walk_bwd"])[1].clone()
        prep["fused_psteps_bwd"] = P.prepare_fused_psteps_bwd(
            weights, h0, labels, gmask, out, gout, gl, htil, stats, ng, vid,
            src, dst, plan, meta)
    prep["msg_bwd"] = MB.prepare_msg_bwd(a3, b3, h0, mask, ng, vid, src, dst,
                                         dmsgs, plan)
    plain["msg_bwd"] = lambda: MB.msg_bwd_reference(
        a3, b3, h0, mask, ng, vid, src, dst, dmsgs, gmask.shape[0])
    return prep, plain, amat.shape[-3]


def _split_trace(name, step):
    """One train step (`step()`) in a torch.profiler trace, its table
    written to profile_split_<name>.txt: (device busy us, device ops).
    The trace reads the second of two steps, the first the profiler's
    warm-up (_trace); fails when it shows no device time."""
    prof = _trace(step)
    busy, ops = _device_ops(prof)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_split_{name}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=40))
    if busy <= 0:
        raise RuntimeError(f"split-times {name}: the trace shows no device "
                           f"time")
    return busy, sum(e.count for e in ops)


def phase_split_times(device, card):
    """lipo and encoded_classification at b1024 (13,184 slots: the split
    route forced) and b3584 (SPLIT_NODES slots: the split route by the
    rule): each split-backward kernel's time (CUDA events over repeated
    launches on the main path's inputs) beside its bound and its plain
    version's; at b3584 the whole route's backward kernel beside the split
    route's three launches; each route's train-step latency (host clock
    ending in a device sync), and at b3584 its device busy time and idle
    share from a trace (the latency medians of 10 steps a route, taken in
    turns: whole, split, split, whole). Returns the b3584 encoded numbers
    per kernel."""
    import statistics
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    gen = torch.Generator().manual_seed(41)
    small = SPLIT_SMALL
    b1024 = batch_to_device(_batch((SMILES * (small // 10 + 1))[:small],
                                   small), device)
    big = _split_check_batches(device)[1]
    out, lines = {}, []
    for bname, tb in ((f"b{small}", b1024), ("b3584", big)):
        for model, family in (("lipo", "shared"), ("encoded", "psteps")):
            tb = dict(tb)
            g = tb["graph_mask"].shape[0]
            afm, bfm = tb["node_feats"].shape[1], tb["edge_feats"].shape[1]
            nafm = tb["node_nafm"].shape[1]
            if family == "shared":
                cfg = zoo.lipo(afm, bfm, nafm)
                tb["labels"] = torch.randn(g, generator=gen).to(device)
                loss = "mse"
            else:
                cfg = zoo.encoded(afm, bfm, nafm, n_out=PS_CLASSES)
                tb["labels"] = torch.randint(0, PS_CLASSES, (g,),
                                             generator=gen).to(device)
                loss = "ce"
            net = network_init(cfg, gen, device)
            opt = adam(net.parameters(), 1e-4, weight_decay=1e-5)
            rec, parts = {}, []

            def step():
                return float(train_step(net, opt, tb, loss_kind=loss))
            for route in ("whole", "split"):
                with _route(route):
                    _dec_reset()
                    for _ in range(3):
                        step()
                    launched = {k for k, v in _launch_counts().items() if v}
                    if ("ro_bwd" in launched) != (route == "split"):
                        raise RuntimeError(f"split-times {model} {bname}: "
                                           f"the {route} route launched "
                                           f"{sorted(launched)}")
            # the step latency in turns, whole, split, split, whole
            lat = {"whole": [], "split": []}
            for route in ("whole", "split", "split", "whole"):
                with _route(route):
                    for _ in range(5):
                        t0 = time.perf_counter()
                        step()
                        torch.cuda.synchronize()
                        lat[route].append((time.perf_counter() - t0) * 1e3)
            for route in ("whole", "split"):
                step_ms = statistics.median(lat[route])
                rec[f"{route}_step_ms"] = step_ms
                part = f"{route} step {step_ms:.3f} ms"
                if bname == "b3584":
                    with _route(route):
                        busy, n_ops = _split_trace(f"{model}_{route}", step)
                    part += (f" (device busy {busy:.1f} us in {n_ops} "
                             f"device ops, idle share "
                             f"{1 - busy / (step_ms * 1e3):.3f})")
                parts.append(part)
            prep, plain, k = _split_launches(family, net, tb, gen)
            bounds = _split_bounds(tb, cfg.mpnn.node_features,
                                   cfg.mpnn.output_dim, k,
                                   cfg.mpnn.message_steps
                                   if family == "psteps" else 1,
                                   cfg.mpnn.msg_norm, cfg.mpnn.state_norm)
            if family == "shared":
                rb = _rec_bounds(tb["node_mask"].shape[0],
                                 float(tb["node_mask"].sum()),
                                 cfg.mpnn.node_features,
                                 cfg.mpnn.message_steps)
                bounds["recurrence_bwd"] = rb["recurrence_bwd"]
            for name, p in prep.items():
                ms = _events_ms(lambda: K.launch_prepared(p), 50)
                rec[name] = dict(ms=ms)
                txt = f"{name} {ms * 1e3:.2f} us"
                if name in plain:
                    with torch.no_grad():
                        rec[name]["plain_ms"] = _events_ms(plain[name], 5,
                                                           warm=1)
                    rec[name].update(bound_ms=bounds[name][0],
                                     bound_by=bounds[name][1])
                    txt += (f" (plain {rec[name]['plain_ms'] * 1e3:.1f} us, "
                            f"bound {bounds[name][0] * 1e3:.3f} us by "
                            f"{bounds[name][1]})")
                parts.append(txt)
            split_sum = sum(rec[n]["ms"] for n in prep if n in plain)
            whole = "fused_step_bwd" if family == "shared" \
                else "fused_psteps_bwd"
            parts.append(f"split backward's three launches "
                         f"{split_sum * 1e3:.2f} us vs {whole} "
                         f"{rec[whole]['ms'] * 1e3:.2f} us")
            out[(bname, model)] = rec
            lines.append(
                f"{model} {bname} ({int(tb['node_mask'].sum())}/"
                f"{tb['node_mask'].shape[0]} slots, "
                f"{int(tb['edge_mask'].sum())} edges, vocab {k}): "
                + ", ".join(parts))
    print(f"split-times [{card}]: " + "; ".join(lines), flush=True)
    return out[("b3584", "encoded")]


# ---------------------------------------------------------------------------
# the shared family's stateless state norm and wide-od buckets, and the
# basic shell (basic_classification, single_target, autoencoder): phases
# 40-42
# ---------------------------------------------------------------------------

BASIC_NORMS = (("none", "stateless"), ("bn1d", "stateless"))
BASIC_ROWS = 1280
SINGLE_ROWS = 500        # 250 classes: single_target's class 243 exists


def _shell_args(tb, w, with_nafm, gen=None, k=None):
    """fused_eval's positional arguments for a device batch whose node
    features (+ nafm with `with_nafm`: the lipo shell's h0, else the basic
    shell's) are h0, random at the padded node slots (the kernels and the
    plain version both mask them out). With k, the real edges take vocab
    ids drawn from 1..k-1 (the padded ones keep 0) and `w` holds k
    tables."""
    import torch
    from mpnn_tpu_torch.graphs.batching import plan_from_batch
    mask = tb["node_mask"]
    h0 = tb["node_feats"]
    if with_nafm:
        h0 = torch.cat([h0, tb["node_nafm"]], -1)
    h0 = (h0 * mask).contiguous()
    if gen is not None:
        pad = torch.nonzero(mask[:, 0] == 0)[:, 0]
        h0 = _noisy(h0[None], pad, gen)[0].contiguous()
    vid = tb["edge_vid"]
    if k is not None:
        real = tb["edge_mask"] > 0
        draw = torch.randint(1, k, vid.shape, generator=gen).to(vid.device)
        vid = torch.where(real, draw.to(vid.dtype), torch.zeros_like(vid))
    return (w["amat"], w["a0"], w["mbias"], h0, mask, tb["node_graph"],
            w["gru"], w["ma"], w["ma_state"], w["bn"], w["bn_state"],
            w["ro"], vid.contiguous(), tb["edge_src"], tb["edge_dst"],
            plan_from_batch(tb))


def _shell_step_args(eval_args, gen):
    """fused_step's positional arguments from fused_eval's (the running
    statistics dropped), every weight and h0 a leaf, random labels and one
    padded graph slot; and the leaves in fused_step's gradient order."""
    import torch
    (amat, a0, mbias, h0, mask, ng, gru, ma, _, bn, _, ro, vid, src, dst,
     plan) = eval_args
    h0 = h0.detach().clone().requires_grad_()
    leaves = [amat, a0, mbias, h0, *gru.values(), *ma.values(),
              *bn.values(), ro["i"]["w"], ro["i"]["b"], ro["j"]["w"],
              ro["j"]["b"]]
    for x in leaves:
        x.requires_grad_()
    g = plan.graph_node_ptr.shape[0] - 1
    labels = torch.randn(g, generator=gen).to(mask.device)
    gmask = torch.ones(g, device=mask.device)
    gmask[-1] = 0.0
    return ((amat, a0, mbias, h0, mask, ng, gru, ma, bn, ro, labels, gmask,
             vid, src, dst, plan), leaves)


def _basic_batches(device):
    """{name: device batch} of the kernel checks and times: bench.py's
    SMILES at b1024 in the 16,512 node slots the serving path gives it
    (past the JAX package's 16,384 layout switch) and 2,560 molecules in
    32,896 slots (_dec_check_batches' batches), b16, a ragged batch with
    single-atom molecules and a padded graph slot, and the wide set's
    (afm 20-27) at b1024 and b16."""
    from mpnn_tpu_torch.train.trainer import batch_to_device
    b1024, b16, b2560, _ = _dec_check_batches(device)
    ragged = SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
    return {"b1024": b1024, "b2560": b2560, "b16": b16,
            "ragged": batch_to_device(_batch(ragged, len(ragged)), device),
            "wide b1024": batch_to_device(
                _batch((WIDE_SMILES * 45)[:1024], 1024), device),
            "wide b16": batch_to_device(_batch(WIDE_SMILES[:16], 16),
                                        device)}


def phase_basic_kernel_check(device):
    """Rows 1-3 in the stateless state norm, (none, stateless) and (bn1d,
    stateless), and in every width bucket, against their plain versions
    (rtol 1e-4, atol 1e-5; gradient leaves divided by their max abs;
    cotangents 1.3·loss + Σ out·c): the serving kernel (the stateless
    norm's cooperative one), the training forward (its statistics too)
    and backward; h0 random at the padded node slots. Narrow: lipo's
    widths (f 10, od 14, T 6) at b1024 (16,512 slots), 2,560 molecules
    (32,896 slots), ragged; o64: the basic shell's (f 7, od 28, T 3) at
    b1024, b16 and with 64 vocab ids; f32: f 23, od 60 at the wide set's
    b16; o128: the basic shell at afm 27 (f 27, od 108) at b1024 and at
    afm 20 with 64 vocab ids at b16 — with (none, none), the basic
    models' pair, in the buckets the basic shell takes."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    gen = torch.Generator().manual_seed(41)
    batches = _basic_batches(device)
    cases = []            # (batch, h0 with nafm, od, T, K or None, modes)
    for name in ("b1024", "b2560", "ragged"):
        cases += [(name, True, 14, 6, None, m) for m in BASIC_NORMS
                  if name != "b2560" or m == BASIC_NORMS[0]]
    cases += [("b1024", False, 28, 3, None, m)
              for m in BASIC_NORMS + (("none", "none"),)]
    cases += [("b1024", False, 28, 3, 64, BASIC_NORMS[1]),
              ("b16", False, 28, 3, None, BASIC_NORMS[0]),
              ("wide b16", True, 60, 3, None, BASIC_NORMS[1])]
    cases += [("wide b1024", False, 108, 3, None, m)
              for m in BASIC_NORMS + (("none", "none"),)]
    cases += [("wide b16", False, 108, 3, 64, BASIC_NORMS[0])]
    worst = dict.fromkeys(("fused_eval", "fused_eval_stateless",
                           "fused_step_fwd", "fused_step_bwd"), 0.0)
    results, failed = [], []
    for name, nafm, od, T, k, (mn, sn) in cases:
        tb = batches[name]
        f = tb["node_feats"].shape[1] + (tb["node_nafm"].shape[1]
                                         if nafm else 0)
        kk = k or int(tb["edge_vfirst"].shape[0])
        w = _random_weights(f, od, kk, gen, device)
        args = _shell_args(tb, w, nafm, gen, k)
        kw = dict(steps=T, msg_norm=mn, state_norm=sn)
        tag = K.width_bucket("", K.BUCKETS, f=f, od=od) or "narrow"
        K.reset_launch_counts()
        with torch.no_grad():
            got = K.fused_eval(*args, **kw)
            torch.cuda.synchronize()
            want = K.fused_eval_reference(*args, **kw)
        ev = "fused_eval_stateless" if sn == "stateless" else "fused_eval"
        ok_e, err_e, _ = _within(got, want)
        worst[ev] = max(worst[ev], err_e)
        sargs, leaves = _shell_step_args(args, gen)
        g = sargs[10].shape[0]
        cw = torch.randn(g, od, generator=gen).to(device)
        sgot = _step_and_grads(K.fused_step, sargs, leaves, cw, kw)
        torch.cuda.synchronize()
        swant = _step_and_grads(K.fused_step_reference, sargs, leaves, cw,
                                kw)
        ok_f, err_f, ok_b, err_b = _step_errors(sgot, swant, mn)
        counts = {key: v for key, v in K.launch_counts.items() if v}
        if counts != {ev: 1, "fused_step_fwd": 1, "fused_step_bwd": 1}:
            raise RuntimeError(f"basic-kernel-check {name}: launches "
                               f"{counts}")
        worst["fused_step_fwd"] = max(worst["fused_step_fwd"], err_f)
        worst["fused_step_bwd"] = max(worst["fused_step_bwd"], err_b)
        what = (f"{name} {mn}/{sn} f={f} od={od} T={T} K={kk} {tag} "
                f"({int(tb['node_mask'].sum())}/{tb['node_mask'].shape[0]}"
                f" slots)")
        ok = ok_e and ok_f and ok_b and bool(torch.isfinite(got).all())
        results.append(f"{what}: {ev} {err_e:.2e} fwd {err_f:.2e} bwd "
                       f"{err_b:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)
    print(f"basic-kernel-check: rows 1-3 vs their plain versions (rtol "
          f"{RTOL} atol {ATOL}; gradients divided by their max abs; h0 "
          f"random at the padded slots): " + "; ".join(results), flush=True)
    # the backward's routes in every bucket
    lines = []
    for name, nafm, od, T, mn, sn, routes in (
            ("b16", False, 28, 3, "none", "none",
             ("cluster 1", "cluster 2", "cluster 4", "grid")),
            ("b1024", False, 28, 3, "none", "stateless",
             ("cluster 8", "grid", "spilled")),
            ("b2560", True, 14, 6, "none", "stateless", ("grid",)),
            ("wide b16", True, 60, 3, "bn1d", "stateless",
             ("cluster 1", "cluster 4", "grid", "spilled")),
            ("wide b16", False, 108, 3, "none", "none",
             ("cluster 1", "cluster 8", "grid")),
            ("wide b16", False, 108, 3, "bn1d", "stateless",
             ("cluster 2", "grid", "spilled"))):
        tb = batches[name]
        f = tb["node_feats"].shape[1] + (tb["node_nafm"].shape[1]
                                         if nafm else 0)
        k = int(tb["edge_vfirst"].shape[0])
        w = _random_weights(f, od, k, gen, device)
        line, err, bad = _bwd_route_checks(
            name, _shell_args(tb, w, nafm, gen), od, T, mn, sn, routes, gen,
            device)
        lines.append(line)
        worst["fused_step_bwd"] = max(worst["fused_step_bwd"], err)
        failed += bad
    print(f"basic-kernel-check: fused_step_bwd's routes in every bucket "
          f"(as kernel-check's): " + "; ".join(lines), flush=True)
    # the forward kernels' routes in every bucket
    lines = []
    for name, nafm, od, T, mn, sn, routes in (
            ("b16", False, 28, 3, "none", "none",
             ("cluster 1", "cluster 4", "grid", "spilled")),
            ("b1024", False, 28, 3, "none", "stateless",
             ("cluster 8", "grid", "spilled")),
            ("b2560", True, 14, 6, "none", "stateless", ("grid",)),
            ("wide b16", True, 60, 3, "bn1d", "stateless",
             ("cluster 1", "cluster 2", "grid", "spilled")),
            ("wide b16", False, 108, 3, "none", "none",
             ("cluster 8", "grid")),
            ("wide b16", False, 108, 3, "bn1d", "stateless",
             ("cluster 4", "grid", "spilled")),
            ("wide b1024", False, 108, 3, "none", "stateless",
             ("grid",))):
        tb = batches[name]
        f = tb["node_feats"].shape[1] + (tb["node_nafm"].shape[1]
                                         if nafm else 0)
        k = int(tb["edge_vfirst"].shape[0])
        w = _random_weights(f, od, k, gen, device)
        line, errs, bad = _fwd_route_checks(
            name, _shell_args(tb, w, nafm, gen), od, T, mn, sn, routes, gen,
            device)
        lines.append(line)
        worst["fused_step_fwd"] = max(worst["fused_step_fwd"], errs["fwd"])
        worst["fused_step_bwd"] = max(worst["fused_step_bwd"], errs["bwd"])
        worst["fused_eval_stateless"] = max(worst["fused_eval_stateless"],
                                            errs["eval"])
        failed += bad
    print(f"basic-kernel-check: the forward kernels' routes in every bucket "
          f"(as kernel-check's): " + "; ".join(lines), flush=True)
    if failed:
        raise RuntimeError(f"rows 1-3 disagree with their plain versions: "
                           f"{failed}")
    return worst


def _api_run(what, cfg, task, train_gs, val_gs, device, files):
    """A config without an experiment through the API: trainer.train for
    one epoch at batch 16 (exact launch counts: one forward and one
    backward per step, one serving launch per validation batch), its
    first 3 losses against the plain path (rtol 1e-3), and the eval step
    (trainer.eval_step_for_batch) on the validation batches against the
    plain path on the same batches. Returns (a report, the launches)."""
    import torch
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_step as K
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train import trainer
    from mpnn_tpu_torch.train.optim import adam
    log = os.path.join(OUT_DIR, f"{files}_train.jsonl")
    if os.path.exists(log):
        os.remove(log)
    tcfg = trainer.TrainConfig(epochs=1, batch_size=16, learning_rate=1e-3,
                               loss=task, seed=317, log_path=log)
    _wide_reset()
    net, hist = trainer.train(cfg, tcfg, train_gs, val_gs, device=device)
    torch.cuda.synchronize()
    n_steps = -(-len(train_gs) // 16)
    n_val = -(-len(val_gs) // 16)
    ev = ("fused_eval_stateless" if cfg.mpnn.state_norm == "stateless"
          else "fused_eval")
    counts = {k: v for k, v in K.launch_counts.items() if v}
    want = {"fused_step_fwd": n_steps, "fused_step_bwd": n_steps,
            ev: n_val}
    if counts != want:
        raise RuntimeError(f"{what}: launches {counts}, the design's count "
                           f"is {want}")
    mlp = _mlp_take(what, 1, n_steps + n_val, n_steps)
    with open(log) as fh:
        steps = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    pnet = network_init(cfg, torch.Generator().manual_seed(317), device)
    opt = adam(pnet.parameters(), 1e-3)
    plain = []
    for b in G.GraphLoader(train_gs, 16, shuffle=True, seed=317):
        if len(plain) == 3:
            break
        plain.append(float(trainer.train_step(
            pnet, opt, trainer.batch_to_device(b, device), fused=False,
            loss_kind=task)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps[:3], plain))
    if not (all(math.isfinite(x) for x in steps) and rel <= 1e-3):
        raise RuntimeError(f"{what}: first steps {steps[:3]} vs plain "
                           f"{plain}")
    errs = []
    for b in G.GraphLoader(val_gs, 16):
        step = trainer.eval_step_for_batch(cfg, task, b)
        tb = trainer.batch_to_device(b, device)
        _, out = step(net, tb)
        with torch.no_grad():
            ref = network_apply_packed(net, tb, fused=False)
        ok, err, _ = _within(out, ref)
        if not (ok and torch.isfinite(out).all()):
            raise RuntimeError(f"{what}: served output vs plain {err:.2e}")
        errs.append(err)
    counts.update(mlp)
    return (f"{what} (f {cfg.mpnn.node_features}, od "
            f"{cfg.mpnn.output_dim}, {cfg.mpnn.msg_norm}/"
            f"{cfg.mpnn.state_norm}): trainer.train {n_steps} steps, "
            f"launches {counts}, first 3 losses vs plain max rel {rel:.2e},"
            f" val_loss {hist[-1]['val_loss']:.5f}; eval step on "
            f"{len(errs)} batches vs plain max_abs {max(errs):.2e}", counts)


def phase_basic(device, card):
    """The basic shell on bench.py's SMILES (afm 7, od 28: the f 16 / od 64
    bucket): basic_classification through `predict` (batch 16 and 1024)
    and `train` (_verb_run), single_target through `train` and `predict`
    on a 250-class CSV (its one-vs-rest class 243, the MLP head), and the
    autoencoder's encoder and the two stateless shared pairs (the basic
    shell with state norm 'stateless', message norm none or bn1d) through
    trainer.train and the eval step (_api_run). Returns the launches of
    rows 1-3."""
    import dataclasses
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.train.cli import apply_experiment_transforms
    from mpnn_tpu_torch.train.split import train_test_split
    os.makedirs(OUT_DIR, exist_ok=True)
    lines = []
    totals = dict.fromkeys(STEP_KERNELS + ("fused_eval_stateless",), 0)

    def add(*counts):
        for c in counts:
            for k in totals:
                totals[k] += c.get(k, 0)
    for exp_name, rows, classes, serve_bs in (
            ("basic_classification", BASIC_ROWS, PS_CLASSES, (16, 1024)),
            ("single_target", SINGLE_ROWS, 250, (16,))):
        exp = experiments.get(exp_name)
        csv = _wide_csv(exp_name, "ce", exp.label_col, smiles=SMILES,
                        rows=rows, classes=classes, prefix="basic")
        gs = apply_experiment_transforms(exp, G.load_classification_dataset(
            csv, "smiles", exp.label_col)[0])
        n_out = int(max(g.label for g in gs)) + 1
        afm, bfm = int(gs[0].afm.shape[-1]), int(gs[0].bfm.shape[-1])
        cfg = zoo.build(exp.model, afm=afm, bfm=bfm, n_out=n_out)
        line, sc, tc = _verb_run(
            exp_name, exp.model, exp, STEP_KERNELS, cfg, csv, rows, "ce",
            n_out, serve_bs=serve_bs, serving_net=False, device=device,
            files=f"basic_{exp_name}")
        lines.append(f"{exp_name} ({n_out} classes): {line}")
        add(sc, tc)
    csv = _wide_csv("api", "ce", "target", smiles=SMILES, rows=BASIC_ROWS,
                    prefix="basic")
    gs = G.load_classification_dataset(csv, "smiles", "target")[0]
    train_gs, val_gs = train_test_split(gs, 0.1, 317)
    afm, bfm = int(gs[0].afm.shape[-1]), int(gs[0].bfm.shape[-1])
    basic = zoo.basic(afm, bfm, n_out=PS_CLASSES)
    # the autoencoder's embeddings (od 2·afm = 14) trained as the logits
    # of the four classes: the API has no loss of its own for them
    for name, cfg in [("autoencoder", zoo.autoencoder(afm, bfm))] + [
            (f"basic {mn}/{sn}", dataclasses.replace(
                basic, mpnn=dataclasses.replace(basic.mpnn, msg_norm=mn,
                                                state_norm=sn)))
            for mn, sn in BASIC_NORMS]:
        line, counts = _api_run(name, cfg, "ce", train_gs[:400], val_gs,
                                device, f"basic_{name.replace('/', '_')}")
        lines.append(line)
        add(counts)
    print(f"basic [{card}]: " + "; ".join(lines), flush=True)
    return totals


def _prep_step(eval_args, meta, gen, tag, device):
    """The prepared training forward and backward launches (the backward
    on the forward's residuals and a random cotangent) for fused_eval's
    arguments, in bucket `tag`; the plain version's arguments; the
    cotangent."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    (amat, a0, mbias, h0, mask, ng, gru, ma, _, bn, _, ro, vid, src, dst,
     plan) = eval_args
    g = plan.graph_node_ptr.shape[0] - 1
    labels = torch.randn(g, generator=gen).to(device)
    gmask = torch.ones(g, device=device)
    weights = K._flat_weights(amat, a0, mbias, gru, ma, bn, ro)
    pf = K.prepare_fused_step_fwd(weights, h0, mask, ng, labels, gmask, vid,
                                  src, dst, plan, meta, tag=tag)
    _, o, st, htil = K.launch_prepared(pf)
    gout = torch.randn(o.shape, generator=gen).to(device)
    gl = torch.ones(1, device=device)
    pb = K.prepare_fused_step_bwd(weights, h0, labels, gmask, o, gout, gl,
                                  htil, st, ng, vid, src, dst, plan, meta,
                                  tag=tag)
    ref = (amat, a0, mbias, h0, mask, ng, gru, ma, bn, ro, labels, gmask,
           vid, src, dst, plan)
    return pf, pb, ref, gout


def phase_basic_times(device, card):
    """At b1024 of bench.py's SMILES (and of the wide set for od 128): the
    CUDA-event time of each of rows 1-3 beside its plain version's time
    and its bound, in the stateless mode at lipo's widths (f 10, od 14, T
    6; the bn1d pair's times are phase_times' and phase_train_times' in
    the same run), at the basic shell's widths (f 7, od 28, T 3) in the
    o64 bucket and forced into the f32 one (the measurement that keeps
    o64 in BUCKETS), and at afm 27 (f 27, od 108) in the o128 bucket.
    The stateless serving kernel in its own bucket also gets its route,
    the empty-forward floor, block 0's clock64 phases and the device time
    of a launch in a trace. Returns the stateless serving kernel's numbers
    at the basic shell's b1024 (its main path's shapes)."""
    import torch
    from mpnn_tpu_torch.kernels import fused_step as K
    gen = torch.Generator().manual_seed(43)
    batches = _basic_batches(device)
    out, lines = {}, []
    for name, nafm, od, T, mn, sn, tags in (
            ("lipo b1024", True, 14, 6, "none", "stateless", ("",)),
            ("lipo b1024", True, 14, 6, "bn1d", "stateless", ("",)),
            ("basic b1024", False, 28, 3, "none", "none", ("o64", "f32")),
            ("basic b1024", False, 28, 3, "none", "stateless",
             ("o64", "f32")),
            ("wide b1024", False, 108, 3, "none", "none", ("o128",)),
            ("wide b1024", False, 108, 3, "bn1d", "stateless", ("o128",))):
        tb = batches[name.replace("lipo ", "").replace("basic ", "")]
        f = tb["node_feats"].shape[1] + (tb["node_nafm"].shape[1]
                                         if nafm else 0)
        k = int(tb["edge_vfirst"].shape[0])
        w = _random_weights(f, od, k, gen, device)
        args = _shell_args(tb, w, nafm)
        kw = dict(steps=T, msg_norm=mn, state_norm=sn)
        meta = K.StepMeta(T, K.BATCH_BN if mn == "bn1d" else K.NONE,
                          K._STATE_MODE[sn])
        ev = "fused_eval_stateless" if sn == "stateless" else "fused_eval"
        bounds = _shell_bounds(tb, f, od, k, T, mn, sn)
        with torch.no_grad():
            p_eval = _events_ms(lambda: K.fused_eval_reference(*args, **kw),
                                10)
        res, detail = {}, ""
        own = K.width_bucket("", K.BUCKETS, f=f, od=od)
        for tag in tags:
            with torch.no_grad():
                pe = K.prepare_fused_eval(*args, **kw, check=False, tag=tag)
                e_ms = _events_ms(lambda: K.launch_prepared(pe), 100)
                pf, pb, ref, gout = _prep_step(args, meta, gen, tag,
                                               device)
                f_ms = _events_ms(lambda: K.launch_prepared(pf), 100)
                b_ms = _events_ms(lambda: K.launch_prepared(pb), 100)
                if sn == "stateless" and tag == own:
                    e_trace = _kernel_trace_us_n(20, pe)[0] / 20 / 1e3
                    route, floor_ms, phases = _fwd_detail(
                        lambda **kw2: K.prepare_fused_eval(
                            *args, **kw, check=False, tag=tag, **kw2),
                        args[3].shape[0], own, k, T, True, device,
                        "fused_eval")
                    detail = (
                        f"; {ev} trace {e_trace * 1e3:.2f} us a launch, "
                        f"route {route}, empty-forward floor "
                        f"{floor_ms * 1e3:.2f} us (events), block 0's "
                        f"clock64 cycles " + json.dumps(
                            {key: round(v) for key, v in phases.items()}))
            res[tag or "narrow"] = (e_ms, f_ms, b_ms)
        with torch.no_grad():
            pf_ms = _events_ms(lambda: K.fused_step_reference(*ref, **kw),
                               10)
        lv = lambda t: t.detach().requires_grad_()
        tree = lambda d: {key: lv(v) for key, v in d.items()}
        amat, a0, mbias, h0 = (lv(x) for x in ref[:4])
        gru, ma, bn = tree(ref[6]), tree(ref[7]), tree(ref[8])
        ro = {"i": tree(ref[9]["i"]), "j": tree(ref[9]["j"])}
        leaves = [amat, a0, mbias, h0, *gru.values(), *ma.values(),
                  *bn.values(), *ro["i"].values(), *ro["j"].values()]
        loss, o_ref, _, _ = K.fused_step_reference(
            amat, a0, mbias, h0, ref[4], ref[5], gru, ma, bn, ro, *ref[10:],
            **kw)
        obj = loss + (o_ref * gout).sum()
        pb_ms = _events_ms(lambda: torch.autograd.grad(
            obj, leaves, retain_graph=True, allow_unused=True), 10)
        tags_s = "; ".join(
            f"{t}: {ev} {v[0] * 1e3:.2f} us, fused_step_fwd "
            f"{v[1] * 1e3:.2f} us, fused_step_bwd {v[2] * 1e3:.2f} us"
            for t, v in res.items())
        lines.append(
            f"{name} {mn}/{sn} (f {f}, od {od}, T {T}, vocab {k}, "
            f"{int(tb['node_mask'].sum())}/{tb['node_mask'].shape[0]} "
            f"slots) {tags_s}; plain {p_eval * 1e3:.1f} / {pf_ms * 1e3:.1f}"
            f" / {pb_ms * 1e3:.1f} us; bound " + ", ".join(
                f"{n} {bounds[n][0] * 1e3:.3f} us by {bounds[n][1]}"
                for n in ("eval", "fused_step_fwd", "fused_step_bwd"))
            + detail)
        if name == "basic b1024" and sn == "stateless":
            e_ms = res[own or "narrow"][0]
            out = dict(ms=e_ms, trace_ms=e_trace, plain_ms=p_eval,
                       bound_ms=bounds["eval"][0],
                       bound_by=bounds["eval"][1])
    print(f"basic-times [{card}]: CUDA events over back-to-back launches; "
          + "; ".join(lines), flush=True)
    return out


def _shell_bounds(b, f, od, k, steps, msg_norm, state_norm):
    """Bounds of rows 1-3 on this batch (_bound_ms, _step_bounds) with the
    norms the pair has: the stateless norm's two batch sums and its
    normalization per step in place of the folded affine, no message norm
    for 'none'."""
    t_eval = _bound_ms(b, f, od, k, steps, stateless=state_norm ==
                       "stateless")
    out = _step_bounds(b, f, od, k, steps, msg_norm, state_norm)
    out["eval"] = t_eval
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
    atts_worst = phase_atts_kernel_check(device)
    atts_counts = phase_att_serve(device, "att")
    for k, v in phase_att_train(device, "att").items():
        atts_counts[k] += v
    atts_times = phase_atts_times(device, card)
    mlp_worst = phase_mlp_kernel_check(device)
    mlp_times = phase_mlp_times(device, card)
    step_counts = phase_wide(device, card)
    bil_worst = phase_bil_kernel_check(device)
    bil_counts = phase_bil_serve(device)
    for k, v in phase_bil_train(device).items():
        bil_counts[k] += v
    bil_times = phase_bil_times(device, card)
    for k, v in phase_ecfp(device, card).items():
        ps_counts[k] += v
    dec_worst = {**phase_spmm_kernel_check(device),
                 **phase_rec_kernel_check(device)}
    phase_dec_train(device)
    dec_times = phase_dec_times(device, card)
    sddmm_worst = phase_sddmm_kernel_check(device)
    phase_dec_att_train(device)
    dec_att_times = phase_dec_att_times(device, card)
    split_worst = phase_split_kernel_check(device)
    phase_split_train(device)
    split_times = phase_split_times(device, card)
    basic_worst = phase_basic_kernel_check(device)
    for k, v in phase_basic(device, card).items():
        step_counts[k] = step_counts.get(k, 0) + v
    stateless_times = phase_basic_times(device, card)
    # rows 1-3's launches: lipo's serve and train phases, the wide phase's
    # lipo and basic, and the basic shell's phase; their errors: every
    # kernel check of them
    for k in worst:
        worst[k] = max(worst[k], basic_worst[k])
    t = times[1024]
    kernels = [{
        "name": "fused_eval", "route": "cuda",
        "source": "mpnn_tpu_torch/csrc/fused_eval.cu",
        "replaces": "mpnn_tpu/kernels/fused_step.py:374",
        "launches": launches + train_counts["fused_eval"]
        + step_counts["fused_eval"],
        "max_abs_err": worst["fused_eval"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        # the stateless state norm's cooperative serving kernel, timed at
        # the basic shell's b1024 (its main path's shapes)
        "name": "fused_eval_stateless", "route": "cuda",
        "source": "mpnn_tpu_torch/csrc/fused_eval.cu",
        "replaces": "mpnn_tpu/kernels/fused_step.py:374",
        "launches": step_counts["fused_eval_stateless"],
        "max_abs_err": worst["fused_eval_stateless"],
        "ms": stateless_times["ms"],
        "trace_ms": stateless_times["trace_ms"],
        "plain_ms": stateless_times["plain_ms"],
        "bound_ms": stateless_times["bound_ms"],
        "bound_by": stateless_times["bound_by"], "library_ms": None}]
    for name, line in (("fused_step_fwd", 232), ("fused_step_bwd", 668)):
        tt = ttimes[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/fused_step.py:{line}",
            "launches": train_counts[name] + step_counts[name],
            "max_abs_err": worst[name],
            "ms": tt["ms"], "trace_ms": tt["trace_us"] / 1e3,
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    for name, line in zip(PS_KERNELS, (1254, 195, 428)):
        tt = ps_times[PS_TIMES_BATCHES[-1]][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/fused_psteps.py:{line}",
            "launches": ps_counts[name], "max_abs_err": ps_worst[name],
            "ms": tt["ms"], **({"trace_ms": tt["trace_ms"]}
                               if "trace_ms" in tt else {}),
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    att_sites = {"fused_att_fwd": "fused_att.py:77",
                 "fused_att_bwd": "fused_att.py:157",
                 "set2vec_fwd": "set2vec.py:84",
                 "set2vec_bwd": "set2vec.py:180"}
    for name in ATT_KERNELS:
        # set2vec reads out both attention models: launches on both paths,
        # the decomposed ones too
        tt = att_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/{att_sites[name]}",
            "launches": (att_counts[name] + atts_counts[name]
                         + DEC_ATT_MAIN.get(name, 0)),
            "max_abs_err": att_worst[name],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    for name, line in zip(ATTS_KERNELS, (561, 634)):
        tt = atts_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/fused_att.py:{line}",
            "launches": atts_counts[name], "max_abs_err": atts_worst[name],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    for name, line in zip(MLP_KERNELS, (48, 115)):
        # every model's A-form build: the main paths' launches (MLP_MAIN),
        # timed at lipo's b1024 shapes
        tt = mlp_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/edge_mlp.py:{line}",
            "launches": MLP_MAIN[name], "max_abs_err": mlp_worst[name],
            "ms": tt["ms"], "trace_ms": tt["trace_ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    for name, line in zip(BIL_KERNELS, (73, 137)):
        tt = bil_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/fused_bilinear.py:{line}",
            "launches": bil_counts[name], "max_abs_err": bil_worst[name],
            "ms": tt["ms"], "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    dec_sites = {"spmm_fwd": "spmm.py:170", "spmm_da": "spmm.py:358",
                 "recurrence_fwd": "recurrence.py:184",
                 "recurrence_bwd": "recurrence.py:214"}
    for name in DEC_KERNELS:
        tt = dec_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/{dec_sites[name]}",
            "launches": DEC_MAIN[name], "max_abs_err": dec_worst[name],
            "ms": tt["ms"], **({"trace_ms": tt["trace_ms"]}
                               if "trace_ms" in tt else {}),
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    for name, line in zip(SDDMM_KERNELS, (46, 134)):
        tt = dec_att_times[1024][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/sddmm.py:{line}",
            "launches": DEC_ATT_MAIN[name], "max_abs_err": sddmm_worst[name],
            "ms": tt["ms"], "trace_ms": tt["trace_ms"],
            "plain_ms": tt["plain_ms"],
            "bound_ms": tt["bound_ms"], "bound_by": tt["bound_by"],
            "library_ms": None})
    split_sites = {"ro_bwd": "fused_step.py:618",
                   "msg_bwd": "fused_step.py:820",
                   "ps_walk_bwd": "fused_psteps.py:616"}
    for name in SPLIT_KERNELS:
        # timed at the per-step family's b3584 (encoded), which runs all
        # three
        tt = split_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpnn_tpu_torch/csrc/{name}.cu",
            "replaces": f"mpnn_tpu/kernels/{split_sites[name]}",
            "launches": SPLIT_MAIN[name], "max_abs_err": split_worst[name],
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
