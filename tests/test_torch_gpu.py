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


# ---------------------------------------------------------------------------
# the training kernels (fused_step_fwd.cu, fused_step_bwd.cu)
# ---------------------------------------------------------------------------

def _step_problem(rng, g, device="cuda"):
    """fused_step's arguments on a _problem batch (its eval-only running
    statistics dropped), with labels and a graph mask, and the weight and
    h0 leaves set to require grad."""
    (amat, a0, mbias, h0, mask, ng, gru, ma_p, _, bn_p, _, ro, vid, src,
     dst, plan) = _problem(rng, g=g, device=device)
    leaves = [amat, a0, mbias, h0, *gru.values(), *ma_p.values(),
              *bn_p.values(), ro["i"]["w"], ro["i"]["b"], ro["j"]["w"],
              ro["j"]["b"]]
    for x in leaves:
        x.requires_grad_(True)
    labels = torch.as_tensor(rng.randn(g).astype(np.float32), device=device)
    gmask = torch.ones(g, device=device)
    gmask[-1] = 0.0                          # one padded graph slot
    args = (amat, a0, mbias, h0, mask, ng, gru, ma_p, bn_p, ro, labels,
            gmask, vid, src, dst, plan)
    names = ["amat", "a0", "mbias", "h0", "w_ih", "w_hh", "b_ih", "b_hh",
             "ma_w", "ma_b", "bn_w", "bn_b", "ro_iw", "ro_ib", "ro_jw",
             "ro_jb"]
    return args, dict(zip(names, leaves))


def step_and_grads(fn, args, leaves, cw, **kw):
    """fn's forward and the gradient of 1.3·loss + Σ out·cw in every
    leaf: (loss, out, ma_stats, step_stats, {leaf: grad})."""
    loss, out, ma, steps = fn(*args, **kw)
    grads = torch.autograd.grad(1.3 * loss + (out * cw).sum(),
                                list(leaves.values()), allow_unused=True)
    return loss, out, ma, steps, {
        k: torch.zeros_like(v) if gr is None else gr
        for (k, v), gr in zip(leaves.items(), grads)}


def assert_step_close(got, want, msg_norm, rtol=RTOL, atol=ATOL):
    """Forward outputs within rtol/atol; each gradient leaf scaled by its
    max abs within rtol/atol; message_bias, whose gradient is zero in
    theory under the message bn1d, by an absolute bound on that scale."""
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
    for (m1, v1), (m2, v2) in zip([got[2], *got[3]], [want[2], *want[3]]):
        torch.testing.assert_close(m1, m2, rtol=rtol, atol=atol)
        torch.testing.assert_close(v1, v2, rtol=rtol, atol=atol)
    for name, g in got[4].items():
        w = want[4][name]
        if name == "mbias" and msg_norm == "bn1d":
            scale = want[4]["a0"].abs().max()
            assert float((g - w).abs().max()) <= atol * float(scale), name
            continue
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("msg_norm,state_norm,g",
                         [("bn1d", "bn1d", 1024), ("bn1d", "none", 1024),
                          ("none", "bn1d", 1024), ("none", "none", 1024),
                          ("bn1d", "bn1d", 37)])
def test_cuda_step_kernels_match_plain_version(msg_norm, state_norm, g):
    """Flagship widths (f 10, od 14, T 6): the forward kernel against
    fused_step_reference, the backward kernel against autograd through it,
    with the cotangents of both the loss and out nonzero. g = 37 is a
    ragged batch: single-atom graphs, padded edges, a padded graph slot."""
    _need_card()
    rng = np.random.RandomState(g)
    args, leaves = _step_problem(rng, g)
    cw = torch.as_tensor(rng.randn(g, 14).astype(np.float32), device="cuda")
    kw = dict(steps=6, msg_norm=msg_norm, state_norm=state_norm)
    K.reset_launch_counts()
    got = step_and_grads(K.fused_step, args, leaves, cw, **kw)
    torch.cuda.synchronize()
    assert (K.launch_counts["fused_step_fwd"],
            K.launch_counts["fused_step_bwd"]) == (1, 1)
    want = step_and_grads(K.fused_step_reference, args, leaves, cw, **kw)
    assert all(torch.isfinite(x).all() for x in got[4].values())
    assert_step_close(got, want, msg_norm)


@pytest.mark.gpu
def test_cuda_step_wrapper_raises_instead_of_falling_back():
    _need_card()
    args, _ = _step_problem(np.random.RandomState(3), 64)
    K.reset_launch_counts()
    bad = list(args)
    bad[0] = args[0].detach().transpose(1, 2)         # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_step(*bad, steps=6)
    bad = list(args)
    bad[10] = args[10].double()
    with pytest.raises(TypeError, match="float32"):
        K.fused_step(*bad, steps=6)
    bad = list(args)
    plan = args[15]
    order = plan.edge_order.clone()
    order[0] = order[1]
    bad[15] = plan._replace(edge_order=order)
    with pytest.raises(ValueError, match="fused_step: plan edge_order"):
        K.fused_step(*bad, steps=6)
    with pytest.raises(NotImplementedError, match="stateless"):
        K.fused_step(*args, steps=6, state_norm="stateless")
    assert K.launch_counts["fused_step_fwd"] == 0
    assert K.launch_counts["fused_step_bwd"] == 0


@pytest.mark.gpu
def test_train_epoch_on_card(tmp_path):
    """One train() epoch of lipo on cuda: every step one forward and one
    backward launch, validation through the eval kernel, finite losses."""
    import json
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.train.trainer import TrainConfig, train
    smiles = ["CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O",
              "c1ccncc1CCO", "C", "NC(=O)c1ccccc1", "CCN"] * 8
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(
        smiles, [0.1 * i for i in range(len(smiles))]))
    cfg = zoo.lipo(ge.atom_width(), ge.bond_width(), 3)
    log = str(tmp_path / "train.jsonl")
    K.reset_launch_counts()
    net, hist = train(cfg, TrainConfig(epochs=1, batch_size=16,
                                       learning_rate=1e-2, plateau=True,
                                       log_path=log),
                      gs[:40], gs[40:], device=device)
    with open(log) as fh:
        losses = [r["loss"] for r in map(json.loads, fh) if "step" in r]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert K.launch_counts["fused_step_fwd"] == 3
    assert K.launch_counts["fused_step_bwd"] == 3
    assert K.launch_counts["fused_eval"] == 1
    assert np.isfinite(hist[0]["val_loss"])


# ---------------------------------------------------------------------------
# the per-step family's kernels (fused_psteps_eval.cu, fused_psteps_fwd.cu,
# fused_psteps_bwd.cu)
# ---------------------------------------------------------------------------

PS_NORMS = [(m, s) for m in ("bn1d", "none")
            for s in ("bn1d", "stateless", "none")]


def _ps_problem(rng, g, f=8, od=16, k=8, steps=3, device="cuda"):
    """A _problem batch with per-step weights: T A tables (vocab id 0 the
    zero row), A0 matrices, message biases, norm pairs and running
    statistics; labels, one padded graph slot, and {leaf: tensor} of the
    training op's differentiable arguments, each requiring grad."""
    (_, _, _, h0, mask, ng, gru, _, _, _, _, ro, vid, src, dst,
     plan) = _problem(rng, g=g, f=f, od=od, k=k, device=device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    amat = rng.randn(steps, k, f, f) * 0.2
    amat[:, 0] = 0.0

    def bn():
        return {"weight": t(1 + 0.2 * rng.randn(f)),
                "bias": t(0.2 * rng.randn(f))}

    def state():
        return {"running_mean": t(0.3 * rng.randn(f)),
                "running_var": t(0.3 + rng.rand(f))}
    c = dict(amat=t(amat), a0=t(rng.randn(steps, f, f) * 0.1),
             mbias=t(rng.randn(steps, f) * 0.1), h0=h0, mask=mask,
             node_graph=ng, gru=gru, ma_bns=[bn() for _ in range(steps)],
             bns=[bn() for _ in range(steps)], ro=ro,
             ma_states=[state() for _ in range(steps)],
             bn_states=[state() for _ in range(steps)],
             labels=t(rng.randn(g)), gmask=torch.ones(g, device=device),
             vid=vid, src=src, dst=dst, plan=plan)
    c["gmask"][-1] = 0.0
    leaves = {"amat": c["amat"], "a0": c["a0"], "mbias": c["mbias"],
              "h0": h0, **{f"gru/{n}": v for n, v in gru.items()},
              **{f"ma{i}/{n}": v for i, b in enumerate(c["ma_bns"])
                 for n, v in b.items()},
              **{f"bn{i}/{n}": v for i, b in enumerate(c["bns"])
                 for n, v in b.items()},
              **{f"ro/{s}/{n}": v for s in ("i", "j")
                 for n, v in ro[s].items()}}
    for x in leaves.values():
        x.requires_grad_(True)
    return c, leaves


def _ps_eval(fn, c, **kw):
    return fn(c["amat"], c["a0"], c["mbias"], c["h0"], c["mask"],
              c["node_graph"], c["gru"], c["ma_bns"], c["ma_states"],
              c["bns"], c["bn_states"], c["ro"], c["vid"], c["src"],
              c["dst"], c["plan"], **kw)


def ps_step_and_grads(fn, c, leaves, cw, **kw):
    """fn's forward and the gradient of 1.3·loss + Σ out·cw in every
    leaf: (loss, out, ma_stats, bn_stats, {leaf: grad})."""
    loss, out, ma, st = fn(
        c["amat"], c["a0"], c["mbias"], c["h0"], c["mask"],
        c["node_graph"], c["gru"], c["ma_bns"], c["bns"], c["ro"],
        c["labels"], c["gmask"], c["vid"], c["src"], c["dst"], c["plan"],
        **kw)
    grads = torch.autograd.grad(1.3 * loss + (out * cw).sum(),
                                list(leaves.values()), allow_unused=True)
    return loss, out, ma, st, {
        k: torch.zeros_like(v) if gr is None else gr
        for (k, v), gr in zip(leaves.items(), grads)}


def assert_ps_close(got, want, msg_norm, rtol=RTOL, atol=ATOL):
    """Forward outputs within rtol/atol; each gradient leaf scaled by its
    max abs; the message biases, whose gradient is zero in theory under
    the message bn1d, by an absolute bound on the A0 gradient's scale."""
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
    for (m1, v1), (m2, v2) in zip([*got[2], *got[3]], [*want[2], *want[3]]):
        torch.testing.assert_close(m1, m2, rtol=rtol, atol=atol)
        torch.testing.assert_close(v1, v2, rtol=rtol, atol=atol)
    for name, g in got[4].items():
        w = want[4][name]
        if name == "mbias" and msg_norm == "bn1d":
            scale = want[4]["a0"].abs().max()
            assert float((g - w).abs().max()) <= atol * float(scale), name
            continue
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("msg_norm,state_norm", PS_NORMS)
def test_cuda_psteps_eval_matches_plain_version(msg_norm, state_norm):
    """Encoded widths (f 8, od 16, T 3) at batch 1024, every norm pair."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_psteps as P
    c, _ = _ps_problem(np.random.RandomState(5), 1024)
    P.reset_launch_counts()
    with torch.no_grad():
        got = _ps_eval(P.fused_psteps_eval, c, steps=3, msg_norm=msg_norm,
                       state_norm=state_norm)
        torch.cuda.synchronize()
        assert P.launch_counts["fused_psteps_eval"] == 1
        want = _ps_eval(P.fused_psteps_eval_reference, c, steps=3,
                        msg_norm=msg_norm, state_norm=state_norm)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("msg_norm,state_norm,g,f,od",
                         [(m, s, 1024, 8, 16) for m, s in PS_NORMS]
                         + [("none", "stateless", 300, 7, 28),
                            ("bn1d", "bn1d", 37, 16, 32)])
def test_cuda_psteps_step_kernels_match_plain_version(msg_norm, state_norm,
                                                      g, f, od):
    """The training forward kernel against fused_psteps_reference and the
    backward kernel against autograd through it, cotangents of both the
    loss and out nonzero: encoded widths at batch 1024 for every norm
    pair, graph_norm's widths (f 7, od 28), and the widest build (f 16,
    od 32) on a ragged batch of 37."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_psteps as P
    rng = np.random.RandomState(g + f)
    c, leaves = _ps_problem(rng, g, f=f, od=od)
    cw = torch.as_tensor(rng.randn(g, od).astype(np.float32), device="cuda")
    kw = dict(steps=3, msg_norm=msg_norm, state_norm=state_norm)
    P.reset_launch_counts()
    got = ps_step_and_grads(P.fused_psteps, c, leaves, cw, **kw)
    torch.cuda.synchronize()
    assert (P.launch_counts["fused_psteps_fwd"],
            P.launch_counts["fused_psteps_bwd"]) == (1, 1)
    want = ps_step_and_grads(P.fused_psteps_reference, c, leaves, cw, **kw)
    assert all(torch.isfinite(x).all() for x in got[4].values())
    assert_ps_close(got, want, msg_norm)


@pytest.mark.gpu
def test_cuda_psteps_wrappers_raise_instead_of_falling_back():
    _need_card()
    from mpnn_tpu_torch.kernels import fused_psteps as P
    c, _ = _ps_problem(np.random.RandomState(7), 64)
    c = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
         for k, v in c.items()}
    P.reset_launch_counts()
    bad = dict(c, amat=c["amat"].transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        _ps_eval(P.fused_psteps_eval, bad, steps=3)
    bad = dict(c, h0=c["h0"].double())
    with pytest.raises(TypeError, match="float32"):
        _ps_eval(P.fused_psteps_eval, bad, steps=3)
    with pytest.raises(NotImplementedError, match="steps=9"):
        _ps_eval(P.fused_psteps_eval, c, steps=9)
    wide, _ = _ps_problem(np.random.RandomState(8), 8, f=P.MAX_WIDTH + 2)
    with pytest.raises(NotImplementedError, match="compiled for f up to"):
        _ps_eval(P.fused_psteps_eval, wide, steps=3)
    assert set(P.launch_counts.values()) == {0}


# ---------------------------------------------------------------------------
# the attention family's kernels (fused_att_fwd.cu, fused_att_bwd.cu,
# set2vec_fwd.cu, set2vec_bwd.cu)
# ---------------------------------------------------------------------------

def _att_problem(rng, g, f=7, k=8, device="cuda"):
    """fused_att's arguments on a _problem batch (ragged graphs, padded
    edges on the dummy node with vid 0, whose A' is NOT zero), and
    {leaf: tensor} of its differentiable arguments, each requiring
    grad."""
    (_, _, _, h0, mask, ng, gru, _, _, _, _, _, vid, src, dst,
     plan) = _problem(rng, g=g, f=f, od=4, k=k, device=device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    w = {"aprime": t(rng.randn(k, f, f) * 0.3), "a0": t(rng.randn(f, f) * 0.3),
         "qv": t(rng.randn(k, f)), "q0": t(rng.randn(f)),
         "wh": t(rng.randn(f, f) * 0.5)}
    leaves = {**w, "h0": h0, **{f"gru/{n}": v for n, v in gru.items()}}
    for x in leaves.values():
        x.requires_grad_(True)
    args = (w["aprime"], w["a0"], w["qv"], w["q0"], w["wh"], h0, mask, ng,
            gru, vid, src, dst, plan)
    return args, leaves


def _grads_close(got, want, rtol=RTOL, atol=ATOL):
    """Each gradient leaf scaled by its max abs within rtol/atol."""
    for name, g in got.items():
        w = want[name]
        scale = w.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")


def _value_and_grads(fn, args, leaves, cw, **kw):
    out = fn(*args, **kw)
    grads = torch.autograd.grad((out * cw).sum(), list(leaves.values()),
                                allow_unused=True)
    return out.detach(), {k: torch.zeros_like(v) if gr is None else gr
                          for (k, v), gr in zip(leaves.items(), grads)}


@pytest.mark.gpu
@pytest.mark.parametrize("with_corr,g,f", [(True, 1024, 7), (False, 1024, 7),
                                           (True, 37, 7), (True, 37, 16)])
def test_cuda_att_kernels_match_plain_version(with_corr, g, f):
    """adv widths (f 7): the forward kernel against fused_att_reference,
    the backward against autograd through it, for 'att' (with_corr) and
    'adj', at batch 1024 and on a ragged batch of 37; and the widest
    build (f 16, the backward's other instantiation)."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_att as A
    rng = np.random.RandomState(g + with_corr)
    args, leaves = _att_problem(rng, g, f=f)
    cw = torch.as_tensor(rng.randn(*args[5].shape).astype(np.float32),
                         device="cuda")
    A.reset_launch_counts()
    got = _value_and_grads(A.fused_att, args, leaves, cw,
                           with_corr=with_corr)
    torch.cuda.synchronize()
    assert (A.launch_counts["fused_att_fwd"],
            A.launch_counts["fused_att_bwd"]) == (1, 1)
    want = _value_and_grads(A.fused_att_reference, args, leaves, cw,
                            with_corr=with_corr)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert all(torch.isfinite(x).all() for x in got[1].values())
    _grads_close(got[1], want[1])
    with torch.no_grad():                     # serving: no message stash
        h = A.fused_att(*args, with_corr=with_corr)
    assert A.launch_counts["fused_att_fwd"] == 2
    torch.testing.assert_close(h, want[0], rtol=RTOL, atol=ATOL)


def _s2v_problem(rng, g, w=14, device="cuda"):
    """set2vec's arguments on a _problem batch: a random masked x (N, w),
    random readout leaves in the JAX layout, each requiring grad."""
    (_, _, _, h0, mask, ng, _, _, _, _, _, _, _, _, _,
     plan) = _problem(rng, g=g, f=4, od=4, k=3, device=device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    b = 1.0 / np.sqrt(2 * w)
    u = lambda *s: t(rng.uniform(-b, b, s))
    rp = {"lstm": {**{f"w_h{k}": u(2 * w, w) for k in "ifgo"},
                   **{f"b_h{k}": u(1, w) for k in "ifgo"}},
          "q_attn": {"w": t(rng.uniform(-1, 1, (w, w)) / np.sqrt(w))},
          "e_attn": {"w": t(rng.uniform(-1, 1, (w, 1)) / np.sqrt(w))}}
    x = t(rng.randn(mask.shape[0], w)) * mask
    leaves = {**{f"lstm/{k}": v for k, v in rp["lstm"].items()},
              "q_attn": rp["q_attn"]["w"], "e_attn": rp["e_attn"]["w"],
              "x": x}
    for v in leaves.values():
        v.requires_grad_(True)
    return (rp, x, mask, ng, plan.graph_node_ptr), leaves


@pytest.mark.gpu
@pytest.mark.parametrize("batch_softmax,steps,g", [
    (True, 100, 1024), (False, 100, 1024), (True, 3, 37), (False, 3, 37)])
def test_cuda_set2vec_kernels_match_plain_version(batch_softmax, steps, g):
    """adv's set width (w 14): the forward kernel against
    set2vec_reference, the backward against autograd through it, both
    softmax modes, the reference's 100 steps at batch 1024 and 3 steps on
    a ragged batch of 37."""
    _need_card()
    from mpnn_tpu_torch.kernels import set2vec as S
    rng = np.random.RandomState(g + steps + batch_softmax)
    args, leaves = _s2v_problem(rng, g)
    cw = torch.as_tensor(rng.randn(g, 28).astype(np.float32), device="cuda")
    kw = dict(time_steps=steps, batch_softmax=batch_softmax)
    S.reset_launch_counts()
    got = _value_and_grads(S.set2vec, args, leaves, cw, **kw)
    torch.cuda.synchronize()
    assert (S.launch_counts["set2vec_fwd"],
            S.launch_counts["set2vec_bwd"]) == (1, 1)
    want = _value_and_grads(S.set2vec_reference, args, leaves, cw, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert all(torch.isfinite(x).all() for x in got[1].values())
    _grads_close(got[1], want[1])


@pytest.mark.gpu
def test_cuda_att_wrappers_raise_instead_of_falling_back():
    _need_card()
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import set2vec as S
    args, _ = _att_problem(np.random.RandomState(9), 64)
    args = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
    A.reset_launch_counts()
    S.reset_launch_counts()
    bad = list(args)
    bad[0] = args[0].transpose(1, 2)                  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        A.fused_att(*bad)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(TypeError, match="float32"):
        A.fused_att(*bad)
    wide, _ = _att_problem(np.random.RandomState(10), 8, f=A.MAX_WIDTH + 1)
    with pytest.raises(NotImplementedError, match="f up to"):
        A.fused_att(*wide)
    s_args, _ = _s2v_problem(np.random.RandomState(11), 16,
                             w=S.MAX_WIDTH + 2)
    with pytest.raises(NotImplementedError, match="w up to"):
        S.set2vec(*s_args, time_steps=3)
    s_args, _ = _s2v_problem(np.random.RandomState(12), 16)
    bad_mask = s_args[2].clone()
    bad_mask[0] = 0.0
    with pytest.raises(ValueError, match="set2vec: mask"):
        S.set2vec(s_args[0], s_args[1], bad_mask, *s_args[3:],
                  time_steps=3)
    assert set(A.launch_counts.values()) == set(
        S.launch_counts.values()) == {0}


@pytest.mark.gpu
def test_adv_serving_path_on_card():
    """predict of adv on cuda (one fused_att_fwd and one set2vec_fwd
    launch per request) against the plain model on cuda, batch by
    batch."""
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import set2vec as S
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train.cli import predict_batches
    from mpnn_tpu_torch.train.trainer import batch_to_device
    smiles = ["CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O",
              "c1ccncc1CCO", "C", "NC(=O)c1ccccc1", "CCN"] * 11
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(smiles,
                                                     [0] * len(smiles)))
    cfg = zoo.adv(ge.atom_width(), ge.bond_width(), n_out=4)
    net = network_init(cfg, torch.Generator().manual_seed(0), device)
    loader = G.GraphLoader(gs, 16)
    A.reset_launch_counts()
    S.reset_launch_counts()
    got = np.concatenate(list(predict_batches(net, "ce", loader, device)))
    assert A.launch_counts == {"fused_att_fwd": len(loader),
                               "fused_att_bwd": 0}
    assert S.launch_counts == {"set2vec_fwd": len(loader),
                               "set2vec_bwd": 0}
    with torch.no_grad():
        want = np.concatenate([
            network_apply_packed(net, batch_to_device(b, device),
                                 fused=False).cpu().numpy()
            for b in loader])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
