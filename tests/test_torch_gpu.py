"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test is marked `gpu` and skips (decided inside the test)
on a host without a CUDA device. This file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance rtol 1e-4 / atol 1e-5: float32 on both sides, with messages and
per-graph rows summed in other orders.
"""

import numpy as np
import pytest
import torch

from mpnn_tpu_torch.graphs.batching import plan_fused_eval
from mpnn_tpu_torch.kernels import fused_step as K

RTOL, ATOL = 1e-4, 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(rng, g=1024, f=10, od=14, k=8, device="cuda"):
    """A packed-like batch: contiguous ragged graphs (1 to 24 nodes, so
    some single-atom graphs), edges inside each graph, padded edges on the
    dummy last node with vid 0, padded nodes carrying node_graph == g."""
    sizes = rng.randint(1, 25, g)
    sizes[:3] = 1
    n_real = int(sizes.sum())
    n = n_real + 1 + rng.randint(0, 64)
    node_graph = np.full(n, g, np.int32)
    node_graph[:n_real] = np.repeat(np.arange(g), sizes)
    src, dst = [], []
    start = 0
    for s in sizes:
        if s > 1:
            for _ in range(2 * s):
                a, b = rng.randint(start, start + s, 2)
                src.append(a)
                dst.append(b)
        start += s
    e_real = len(src)
    pad = rng.randint(1, 128)
    src = np.array(src + [n - 1] * pad, np.int32)
    dst = np.array(dst + [n - 1] * pad, np.int32)
    vid = np.concatenate([rng.randint(1, k, e_real), np.zeros(pad)]
                         ).astype(np.int32)
    mask = (np.arange(n) < n_real).astype(np.float32)[:, None]
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    i = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    r = lambda *s_, sc=1.0: t(rng.randn(*s_) * sc)
    amat = rng.randn(k, f, f) * 0.2
    amat[0] = 0.0
    plan = plan_fused_eval(dst, node_graph, g)

    def bn():
        return ({"weight": t(1 + 0.2 * rng.randn(f)),
                 "bias": t(0.2 * rng.randn(f))},
                {"running_mean": t(0.3 * rng.randn(f)),
                 "running_var": t(0.3 + rng.rand(f))})
    ma_p, ma_s = bn()
    bn_p, bn_s = bn()
    return (t(amat), r(f, f, sc=0.1), r(f, sc=0.1),
            t(rng.randn(n, f) * mask), t(mask), i(node_graph),
            {"w_ih": r(f, 3 * f, sc=0.3), "w_hh": r(f, 3 * f, sc=0.3),
             "b_ih": r(3 * f, sc=0.1), "b_hh": r(3 * f, sc=0.1)},
            ma_p, ma_s, bn_p, bn_s,
            {"i": {"w": r(2 * f, od, sc=0.3), "b": r(od, sc=0.1)},
             "j": {"w": r(2 * f, od, sc=0.3), "b": r(od, sc=0.1)}},
            i(vid), i(src), i(dst), K.FusedEvalPlan(*(i(p) for p in plan)))


@pytest.mark.gpu
@pytest.mark.parametrize("msg_norm,state_norm",
                         [("bn1d", "bn1d"), ("bn1d", "none"),
                          ("none", "bn1d"), ("none", "none")])
def test_cuda_kernel_matches_plain_version(msg_norm, state_norm):
    """Flagship widths (f 10, od 14, T 6) at batch 1024."""
    _need_card()
    args = _problem(np.random.RandomState(0))
    K.reset_launch_counts()
    got = K.fused_eval(*args, steps=6, msg_norm=msg_norm,
                       state_norm=state_norm)
    torch.cuda.synchronize()
    assert K.launch_counts["fused_eval"] == 1
    want = K.fused_eval_reference(*args, steps=6, msg_norm=msg_norm,
                                  state_norm=state_norm)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("f,od,k", [(8, 6, 5), (16, 16, 12), (12, 9, 40)])
def test_cuda_kernel_other_widths(f, od, k):
    """Widths below and at the compiled 16, and a vocab of 40 whose
    weights need more than 48 KB of shared memory."""
    _need_card()
    args = _problem(np.random.RandomState(f), g=300, f=f, od=od, k=k)
    got = K.fused_eval(*args, steps=3)
    want = K.fused_eval_reference(*args, steps=3)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back():
    _need_card()
    args = list(_problem(np.random.RandomState(1), g=64))
    K.reset_launch_counts()
    bad = list(args)
    bad[0] = args[0].transpose(1, 2)                  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_eval(*bad, steps=6)
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(TypeError, match="float32"):
        K.fused_eval(*bad, steps=6)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        K.fused_eval(*bad, steps=6)
    with pytest.raises(NotImplementedError, match="stateless"):
        K.fused_eval(*args, steps=6, state_norm="stateless")
    wide = _problem(np.random.RandomState(2), g=8, f=K.MAX_WIDTH + 8)
    with pytest.raises(NotImplementedError, match="widths up to"):
        K.fused_eval(*wide, steps=6)
    assert K.launch_counts["fused_eval"] == 0


@pytest.mark.gpu
def test_serving_path_on_card():
    """predict on cuda (the kernel) against the plain model on cuda, one
    launch per request."""
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train.cli import predict_batches
    from mpnn_tpu_torch.train.trainer import batch_to_device
    smiles = ["CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O",
              "c1ccncc1CCO", "C", "NC(=O)c1ccccc1", "CCN"] * 11
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(smiles,
                                                     [0.0] * len(smiles)))
    cfg = zoo.lipo(ge.atom_width(), ge.bond_width(), 3)
    net = network_init(cfg, torch.Generator().manual_seed(0), device)
    loader = G.GraphLoader(gs, 16, collate="packed")
    K.reset_launch_counts()
    got = np.concatenate([o.reshape(-1) for o in
                          predict_batches(net, "mse", loader, device)])
    assert K.launch_counts["fused_eval"] == len(loader)
    with torch.no_grad():
        want = np.concatenate([
            network_apply_packed(net, batch_to_device(b, device),
                                 fused=False).reshape(-1).cpu().numpy()
            for b in loader])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
