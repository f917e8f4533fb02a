"""What the training backward's source-sorted edge order costs, on a CUDA
card, for the PyTorch port (mpnn_tpu_torch):

  * the lipo train step (chip_smoke.py's batches of 16 and 1024) with the
    order built on the device at every backward launch
    (kernels/fused_step.py::source_order) against the same step with the
    order built once and reused, interleaved A B B A A B in one process;
  * one source_order call by CUDA events and by the host clock;
  * the host index plan of a packed batch of 1024 (plan_fused_eval) with
    and without a second stable argsort by source, which every serving
    batch paid when the order was built on the host.

    python scripts/torch_source_order_ab.py

Needs one CUDA card; builds the kernels first. Prints the card's name and
power limit and one JSON line per measurement.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from mpnn_tpu_torch.graphs.batching import plan_fused_eval  # noqa: E402
from mpnn_tpu_torch.kernels import build  # noqa: E402
from mpnn_tpu_torch.kernels import fused_step as K  # noqa: E402
from mpnn_tpu_torch.train.trainer import batch_to_device, train_step  # noqa


def _step_ms(net, opt, tb, reps=30):
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(train_step(net, opt, tb))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def _host_plan_ms(b, reps=50):
    """(plan_fused_eval ms, the same plus the source argsort ms)."""
    dst, src, ng = b["edge_dst"], b["edge_src"], b["node_graph"]
    g = int(b["graph_mask"].shape[0])
    n = ng.shape[0]

    def with_src():
        plan_fused_eval(dst, ng, g)
        s = np.asarray(src).astype(np.int64)
        np.argsort(s, kind="stable").astype(np.int32)
        np.concatenate([[0], np.cumsum(np.bincount(s, minlength=n))])
    out = []
    for fn in (lambda: plan_fused_eval(dst, ng, g), with_src):
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        out.append(statistics.median(t))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    real, cache = K.source_order, {}

    def reused(src, n):
        key = (src.data_ptr(), n)
        if key not in cache:
            cache[key] = real(src, n)
        return cache[key]
    for bs in (16, 1024):
        gen = torch.Generator().manual_seed(2)
        b = C._batch((C.SMILES * (bs // len(C.SMILES) + 1))[:bs], bs)
        b["labels"] = torch.randn(bs, generator=gen).numpy()
        tb = batch_to_device(b, device)
        net, opt = C._train_net(b, gen, device)
        for _ in range(3):
            float(train_step(net, opt, tb))
        seq = []
        for mode in ("device", "reused", "reused", "device", "device",
                     "reused"):
            K.source_order = real if mode == "device" else reused
            seq.append([mode, _step_ms(net, opt, tb)])
        K.source_order = real
        src, n = tb["edge_src"], tb["node_feats"].shape[0]
        ev_ms = C._events_ms(lambda: real(src, n), 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            real(src, n)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        rec = {"batch": bs, "train_step_ms": seq,
               "source_order_events_us": ev_ms * 1e3,
               "source_order_host_us": host_us}
        if bs == 1024:
            rec["host_plan_ms"], rec["host_plan_with_src_ms"] = \
                _host_plan_ms(b)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
