"""Rehearse chip_smoke.py's phases on the CPU: every kernel of the port
built for the CUDA stand-in (emu.py) and run through its wrapper, the
entry points sent to the CPU, CUDA events and syncs stubbed. It finds
wrong paths, arguments, launch counts and comparisons before a chip call;
its times and profiles mean nothing. Run from the repository root:

    python scripts/cuda_emu/rehearse_smoke.py [phase ...]

phases: kernel-check, train-times, basic-kernel-check, basic-times (the
shared family's kernels, row 2's forward kernels and row 3's backward on
every route, their floors and clock64 phases: batch 48 for 1024, 64
molecules in 2,000 slots for 2,560), att-kernel-check, att-times
(set2vec's routes, its empty-step
floor and clock64 phases; batch 48 for 1024, 3 set2vec steps, the
empty-block case on 27 graphs, the many-graph cases on 130, 60 and
230),
mlp-kernel-check,
mlp-times, wide, bil-kernel-check, bil-serve,
bil-train, bil-times, ecfp, spmm-kernel-check, rec-kernel-check,
dec-train, dec-times, sddmm-kernel-check, dec-att-train, dec-att-times,
split-kernel-check, split-train, split-times (default all). The split
phases run at batch 48 (1,024 node slots for the kernel check; 160
molecules for split-train) and 16 for the whole route, the route rule's
limits lowered so that 48 molecules split and 16 do not. The wide phase
runs on 48 molecules with set2vec cut to 3
steps (in every adv and att run); bil-train, ecfp, dec-train and
dec-att-train on 64; rec-kernel-check at b16's and 2,000 node slots;
dec-times and dec-att-times at batch 16 and 48, without a trace (the
stand-in has no device to trace); spmm- and sddmm-kernel-check at batch
48 for 1024 and 64 molecules in 2,000 slots for 2,560 (the SDDMM's
smallest tiles sized for 24 SMs).
"""

import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [HERE, REPO]

import torch                                                   # noqa: E402

import emu                                                     # noqa: E402
from mpnn_tpu_torch.kernels import (edge_mlp, fused_att,       # noqa: E402
                                    fused_att_steps, fused_bilinear,
                                    fused_psteps, fused_step, msg_bwd,
                                    psteps_walk, readout_bwd, recurrence,
                                    sddmm, set2vec, spmm, split_bwd)

ARGS = {"fused_eval": "mpnn_step::FwdArgs", "fused_step_fwd": "FwdArgs",
        "fused_step_bwd": "BwdArgs", "fused_psteps_eval": "PsFwdArgs",
        "fused_psteps_fwd": "PsFwdArgs", "fused_psteps_bwd": "PsBwdArgs",
        "fused_att_fwd": "FwdArgs", "fused_att_bwd": "BwdArgs",
        "fused_att_steps_fwd": "FwdArgs", "fused_att_steps_bwd": "BwdArgs",
        "set2vec_fwd": "FwdArgs", "set2vec_bwd": "BwdArgs",
        "edge_mlp_fwd": "FwdArgs", "edge_mlp_bwd": "BwdArgs",
        "fused_bilinear_fwd": "FwdArgs", "fused_bilinear_bwd": "BwdArgs",
        "spmm_fwd": "FwdArgs", "spmm_da": "DaArgs",
        "recurrence_fwd": "FwdArgs", "recurrence_bwd": "BwdArgs",
        "sddmm_fwd": "FwdArgs", "sddmm_bwd": "BwdArgs",
        "ro_bwd": "RoArgs", "msg_bwd": "MsgArgs", "ps_walk_bwd": "WalkArgs"}


class _Event:
    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def main(argv) -> int:
    emu.build([f"{lib}:{ARGS[lib.partition('.')[0]]}"
               for lib in emu.B.all_libraries()])
    emu.emulate(fused_step, fused_psteps, fused_att, fused_att_steps,
                set2vec, edge_mlp, fused_bilinear, spmm, recurrence, sddmm,
                readout_bwd, msg_bwd, psteps_walk)
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.Event = _Event
    cpu = torch.device("cpu")
    from mpnn_tpu_torch import device as D
    from mpnn_tpu_torch.models import network
    from mpnn_tpu_torch.train import checkpoint, trainer
    for mod in (D, network, checkpoint, trainer):
        mod.resolve_device = lambda device=None: cpu
    import chip_smoke as CS
    # one launch per timing: the stand-in's times mean nothing; a smaller
    # wide data set (a thread per CUDA thread is slow)
    CS._events_ms = lambda fn, reps, warm=5: (fn(), 0.0)[1]

    def trace_us(*prepared):            # the stand-in has no device trace
        for p in prepared:
            fused_step.launch_prepared(p)
        return {p.name: 1.0 for p in prepared}
    CS._kernel_trace_us = trace_us
    CS.MLP_FLOOR_REPEAT = 1
    CS.WIDE_ROWS = 48
    CS.TRAIN_ROWS = CS.ECFP_ROWS = 64
    CS.REC_NODES = (2000,)
    CS.DEC_TIMES_BATCHES = CS.DEC_ATT_BATCHES = (16, 48)
    CS._dec_trace = lambda *a: (0.0, "no trace (emulated)")
    CS._split_trace = lambda name, step: (step(), (0.0, 0))[1]
    CS.SPLIT_ROWS, CS.SPLIT_BATCH, CS.SPLIT_NODES = 160, 48, 1024
    CS.SPLIT_SMALL = 16

    def lower_split():
        """The split phases' limits: 48 molecules split, 16 do not."""
        split_bwd.PS_WHOLE_NPAD_CAP = 384
        split_bwd.WHOLE_BWD_BYTES = 800_000

    def split_batches(device):
        """split-kernel-check's batches cut: b16 for b1024, 48 molecules
        in SPLIT_NODES slots for b3584."""
        from mpnn_tpu_torch import graphs as G
        from mpnn_tpu_torch.graphs.batching import attach_fused_plan
        gs, _ = G.encode_molgraphs(G.generate_molgraphs(
            (CS.SMILES * 5)[:CS.SPLIT_BATCH], [0.0] * CS.SPLIT_BATCH))
        big = trainer.batch_to_device(attach_fused_plan(G.attach_edge_vocab(
            G.collate_packed(gs, node_cap=CS.SPLIT_NODES).as_dict(),
            vocab_cap=8)), device)
        b16 = trainer.batch_to_device(CS._batch(CS.SMILES * 2, 16), device)
        return b16, big, b16, CS._ragged_att_batch(device)
    CS._split_check_batches = split_batches
    # set2vec's 100 steps cut to 3: the stand-in takes seconds a step
    from mpnn_tpu_torch.models import zoo
    for name in ("adv", "att"):
        def cut(*a, _build=zoo.ZOO[name], **kw):
            cfg = _build(*a, **kw)
            return dataclasses.replace(cfg, mpnn=dataclasses.replace(
                cfg.mpnn, set2vec_steps=3))
        zoo.ZOO[name] = cut
    # att-kernel-check and att-times: batch 48 for 1024, 3 set2vec steps,
    # the empty block's case on 27 graphs (block 1 of 3 empty: the wide
    # backward holds ~10 graphs a block), the many-graph cases sized for 3
    # SMs (the same routes)
    CS.ATT_CHECK_BATCH, CS.ATT_TIMES_BATCHES = 48, (16, 48)
    CS.S2V_STEPS = 3
    CS.S2V_EMPTY_BLOCK = (27, slice(9, 18))
    CS.S2V_MANY_GRAPHS = {"global-acc": 130, "spilled-bwd": 60,
                          "spilled": 230}
    # the cases' expected route tags are an H100's (132 SMs): on the
    # stand-in's 3 SMs a batch's tags are what its launch shape gives
    cases = CS._s2v_route_cases

    def emulated_cases(b16):
        out = []
        for name, sizes, w, t, _ in cases(b16):
            ptr = [0, *(int(v) for v in torch.as_tensor(sizes).cumsum(0))]
            n = ptr[-1] + 5
            out.append((name, sizes, w, t, tuple(
                set2vec.device_shape(d, n, len(sizes), w, "cpu").tag(ptr)
                for d in ("fwd", "bwd"))))
        return out
    CS._s2v_route_cases = emulated_cases
    # kernel-check, train-times and basic-kernel-check (row 3's routes):
    # batch 48 for 1024, the wide set's 48 for its 1024, 64 molecules in
    # 2,000 slots for 2,560 in 32,896
    CS.CHECK_BATCH, CS.TRAIN_TIMES_BATCHES = 48, (16, 48)

    def basic_batches(device):
        from mpnn_tpu_torch import graphs as G
        from mpnn_tpu_torch.graphs.batching import attach_fused_plan
        gs, _ = G.encode_molgraphs(G.generate_molgraphs(
            (CS.SMILES * 7)[:64], [0.0] * 64))
        big = trainer.batch_to_device(attach_fused_plan(G.attach_edge_vocab(
            G.collate_packed(gs, node_cap=2000).as_dict())), device)
        b = lambda sm, n: trainer.batch_to_device(CS._batch(sm[:n], n),
                                                  device)
        ragged = CS.SMILES[:7] + ["C", "O", "CCO", "C", "[NH4+]"]
        return {"b1024": b(CS.SMILES * 5, 48), "b2560": big,
                "b16": b(CS.SMILES * 2, 16),
                "ragged": b(ragged, len(ragged)),
                "wide b1024": b(CS.WIDE_SMILES * 3, 48),
                "wide b16": b(CS.WIDE_SMILES, 16)}
    CS._basic_batches = basic_batches

    def dec_batches(device):
        """spmm- and sddmm-kernel-check's batches cut: 48 molecules for
        1024, 64 in 2,000 slots for 2,560 in 32,896."""
        from mpnn_tpu_torch import graphs as G
        from mpnn_tpu_torch.graphs.batching import attach_fused_plan
        gs, _ = G.encode_molgraphs(G.generate_molgraphs(
            (CS.SMILES * 7)[:64], [0.0] * 64))
        big = trainer.batch_to_device(attach_fused_plan(G.attach_edge_vocab(
            G.collate_packed(gs, node_cap=2000).as_dict(), vocab_cap=8)),
            device)
        b48 = trainer.batch_to_device(CS._batch(CS.SMILES * 5, 48), device)
        b16 = trainer.batch_to_device(CS._batch(CS.SMILES * 2, 16), device)
        return b48, b16, big, CS._ragged_att_batch(device)
    CS._dec_check_batches = dec_batches
    # the SDDMM kernels' forced tiles within the stand-in's thread limit
    # (~20k CUDA threads a launch): the largest, a group 8 positions
    CS.SDDMM_ROUTES["small tiles"] = dict(per=(8, 8))
    phases = {"kernel-check": lambda: CS.phase_kernel_check(cpu),
              "train-times": lambda: CS.phase_train_times(cpu, "emulated"),
              "basic-kernel-check": lambda: CS.phase_basic_kernel_check(cpu),
              "basic-times": lambda: CS.phase_basic_times(cpu, "emulated"),
              "att-kernel-check": lambda: CS.phase_att_kernel_check(cpu),
              "att-times": lambda: CS.phase_att_times(cpu, "emulated"),
              "mlp-kernel-check": lambda: CS.phase_mlp_kernel_check(cpu),
              "mlp-times": lambda: CS.phase_mlp_times(cpu, "emulated"),
              "wide": lambda: CS.phase_wide(cpu, "emulated"),
              "bil-kernel-check": lambda: CS.phase_bil_kernel_check(cpu),
              "bil-serve": lambda: CS.phase_bil_serve(cpu),
              "bil-train": lambda: CS.phase_bil_train(cpu),
              "bil-times": lambda: CS.phase_bil_times(cpu, "emulated"),
              "ecfp": lambda: CS.phase_ecfp(cpu, "emulated"),
              "spmm-kernel-check": lambda: CS.phase_spmm_kernel_check(cpu),
              "rec-kernel-check": lambda: CS.phase_rec_kernel_check(cpu),
              "dec-train": lambda: CS.phase_dec_train(cpu),
              "dec-times": lambda: CS.phase_dec_times(cpu, "emulated"),
              "sddmm-kernel-check": lambda: CS.phase_sddmm_kernel_check(cpu),
              "dec-att-train": lambda: CS.phase_dec_att_train(cpu),
              "dec-att-times": lambda: CS.phase_dec_att_times(cpu,
                                                              "emulated"),
              "split-kernel-check": lambda: (
                  lower_split(), CS.phase_split_kernel_check(cpu)),
              "split-train": lambda: (lower_split(),
                                      CS.phase_split_train(cpu)),
              "split-times": lambda: (
                  lower_split(), CS.phase_split_times(cpu, "emulated"))}
    for name in argv or list(phases):
        phases[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
