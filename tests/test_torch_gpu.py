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


def _problem(rng, g=1024, f=10, od=14, k=8, device="cuda", big=0):
    """A packed-like batch: contiguous ragged graphs (1 to 24 nodes, so
    some single-atom graphs), edges inside each graph, padded edges on the
    dummy last node with vid 0, padded nodes carrying node_graph == g;
    with `big`, graph g // 2 has that many nodes."""
    sizes = rng.randint(1, 25, g)
    sizes[:min(3, g - 1)] = 1
    if big:
        sizes[g // 2] = big
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
                          ("none", "bn1d"), ("none", "none"),
                          ("none", "stateless"), ("bn1d", "stateless")])
def test_cuda_kernel_matches_plain_version(msg_norm, state_norm):
    """Flagship widths (f 10, od 14, T 6) at batch 1024; the stateless
    state norm through its cooperative kernel, by this batch's own
    statistics."""
    _need_card()
    args = _problem(np.random.RandomState(0))
    K.reset_launch_counts()
    got = K.fused_eval(*args, steps=6, msg_norm=msg_norm,
                       state_norm=state_norm)
    torch.cuda.synchronize()
    stateless = state_norm == "stateless"
    assert (K.launch_counts["fused_eval"],
            K.launch_counts["fused_eval_stateless"]) == (int(not stateless),
                                                         int(stateless))
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
    with pytest.raises(ValueError, match="state norm in"):
        K.fused_eval(*args, steps=6, state_norm="batch")
    wide = _problem(np.random.RandomState(2), g=8, f=K.MAX_WIDTH + 8)
    with pytest.raises(NotImplementedError, match="widths up to"):
        K.fused_eval(*wide, steps=6)
    with pytest.raises(NotImplementedError, match="widths up to"):
        K.fused_eval(*wide, steps=6, state_norm="stateless")
    assert K.launch_counts["fused_eval"] == 0
    assert K.launch_counts["fused_eval_stateless"] == 0


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

STEP_LEAVES = ["amat", "a0", "mbias", "h0", "w_ih", "w_hh", "b_ih", "b_hh",
               "ma_w", "ma_b", "bn_w", "bn_b", "ro_iw", "ro_ib", "ro_jw",
               "ro_jb"]


def _step_problem(rng, g, f=10, od=14, k=8, device="cuda", big=0):
    """fused_step's arguments on a _problem batch (its eval-only running
    statistics dropped), with labels and a graph mask, and the weight and
    h0 leaves set to require grad."""
    (amat, a0, mbias, h0, mask, ng, gru, ma_p, _, bn_p, _, ro, vid, src,
     dst, plan) = _problem(rng, g=g, f=f, od=od, k=k, device=device,
                           big=big)
    leaves = [amat, a0, mbias, h0, *gru.values(), *ma_p.values(),
              *bn_p.values(), ro["i"]["w"], ro["i"]["b"], ro["j"]["w"],
              ro["j"]["b"]]
    for x in leaves:
        x.requires_grad_(True)
    labels = torch.as_tensor(rng.randn(g).astype(np.float32), device=device)
    gmask = torch.ones(g, device=device)
    if g > 1:
        gmask[-1] = 0.0                      # one padded graph slot
    args = (amat, a0, mbias, h0, mask, ng, gru, ma_p, bn_p, ro, labels,
            gmask, vid, src, dst, plan)
    return args, dict(zip(STEP_LEAVES, leaves))


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


def float64_step_and_grads(args, cw, **kw):
    """step_and_grads through fused_step_reference in float64 on the same
    batch: the exact side where float32 in any summation order sits past
    1e-5 of it (scripts/time_fused_step.py --witness prints both sides'
    distances)."""
    def dbl(x):
        if isinstance(x, dict):
            return {k: dbl(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.detach().double()
        return x
    a64 = [dbl(a) for a in args]
    amat, a0, mbias, h0, _, _, gru, ma_p, bn_p, ro = a64[:10]
    leaves = [amat, a0, mbias, h0, *gru.values(), *ma_p.values(),
              *bn_p.values(), ro["i"]["w"], ro["i"]["b"], ro["j"]["w"],
              ro["j"]["b"]]
    for x in leaves:
        x.requires_grad_(True)
    return step_and_grads(K.fused_step_reference, tuple(a64),
                          dict(zip(STEP_LEAVES, leaves)), cw.double(), **kw)


def exactness(got, want, exact, msg_norm):
    """Each output and gradient leaf's distance from the float64 answer,
    scaled by that answer's max abs, for the kernel (`got`) and the plain
    float32 version (`want`): {name: (kernel, plain)}; message_bias under
    the message bn1d (zero in theory) left out."""
    pairs = [("loss", got[0], want[0], exact[0]),
             ("out", got[1], want[1], exact[1])] + [
        (n, got[4][n], want[4][n], exact[4][n]) for n in exact[4]
        if not (n == "mbias" and msg_norm == "bn1d")]
    out = {}
    for name, k, p, x in pairs:
        scale = x.abs().max().clamp_min(1e-30)
        out[name] = tuple(float(((y.double() - x) / scale).abs().max())
                          for y in (k, p))
    return out


def _stash_case(args, od, fwd, **kw):
    """The training forward's residuals (loss, out, stats, htil) on the
    forced forward route `fwd` against the plain version's (padded stash
    slots zero, the same bits twice) and, with the stateless state norm,
    the serving kernel on that route against fused_eval_reference (the
    message norm folded from unit running statistics); returns the
    route's FwdShape."""
    from chip_smoke import _fwd_route, _route_matches
    (amat, a0, mbias, h0, mask, ng, gru, ma, bn, ro, labels, gmask, vid,
     src, dst, plan) = args
    det = lambda d: {key: (det(v) if isinstance(v, dict) else v.detach())
                     for key, v in d.items()}
    weights = K._flat_weights(amat.detach(), a0.detach(), mbias.detach(),
                              det(gru), det(ma), det(bn), det(ro))
    meta = K.StepMeta(kw["steps"],
                      K.BATCH_BN if kw["msg_norm"] == "bn1d" else K.NONE,
                      K._STATE_MODE[kw["state_norm"]])
    res = (weights, h0.detach(), mask, ng, labels, gmask, vid, src, dst,
           plan, meta)
    n, f = h0.shape
    with _fwd_route(fwd):
        got = K.forward_residuals(*res)
        again = K.forward_residuals(*res)
        shape = K.device_fwd_shape(
            n, K.width_bucket("", K.BUCKETS, f=f, od=od), amat.shape[0],
            kw["steps"], kw["msg_norm"] != "none" or kw["state_norm"] != "none",
            h0.device)
        if kw["state_norm"] == "stateless":
            unit = {"running_mean": torch.zeros_like(mbias.detach()),
                    "running_var": torch.ones_like(mbias.detach())}
            eargs = (amat.detach(), a0.detach(), mbias.detach(), h0.detach(),
                     mask, ng, det(gru), det(ma), unit, det(bn), unit,
                     det(ro), vid, src, dst, plan)
            K.reset_launch_counts()
            served = K.fused_eval(*eargs, **kw)
            served2 = K.fused_eval(*eargs, **kw)
            assert K.launch_counts["fused_eval_stateless"] == 2
            torch.testing.assert_close(
                served, K.fused_eval_reference(*eargs, **kw), rtol=RTOL,
                atol=ATOL)
            assert torch.equal(served, served2), "serving: bits differ"
    want = K._reference_residuals(*res)
    for name, a, b, c in zip(("loss", "out", "stats", "htil"), got, want,
                             again):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(a, c), f"{name}: bits differ"
    n_real = int(mask.sum())
    if n > n_real:
        assert float(got[3][:, n_real:].abs().max()) == 0.0, "padded slots"
    assert _route_matches(shape, fwd), shape.tag()
    return shape


def _step_case(args, leaves, cw, route, od, exact=False, fwd=None, **kw):
    """One forward and one backward launch on `route`, against the plain
    version, and the same bits again; returns the route's BwdShape. The
    backward's route is forced as chip_smoke.py forces it (None: the
    rule's), and the forward's (`fwd`) too: then its residuals are held to
    the plain version's (_stash_case). With `exact`, each output and leaf
    is held to the float64 answer instead: within atol of it, or no
    further from it than the plain float32 version is."""
    from chip_smoke import _bwd_route, _fwd_route, _route_matches
    h0, k = args[3], args[0].shape[0]
    with _bwd_route(route), _fwd_route(fwd):
        K.reset_launch_counts()
        got = step_and_grads(K.fused_step, args, leaves, cw, **kw)
        torch.cuda.synchronize()
        assert (K.launch_counts["fused_step_fwd"],
                K.launch_counts["fused_step_bwd"]) == (1, 1)
        again = step_and_grads(K.fused_step, args, leaves, cw, **kw)
        shape = K.device_bwd_shape(
            h0.shape[0], K.width_bucket("", K.BUCKETS, f=h0.shape[1],
                                        od=od), k, kw["steps"],
            kw["state_norm"] != "none", h0.device)
    if fwd is not None:
        _stash_case(args, od, fwd, **kw)
    want = step_and_grads(K.fused_step_reference, args, leaves, cw, **kw)
    assert all(torch.isfinite(x).all() for x in got[4].values())
    if exact:
        dist = exactness(got, want, float64_step_and_grads(args, cw, **kw),
                         kw["msg_norm"])
        far = {n: d for n, d in dist.items() if d[0] > max(ATOL, d[1])}
        assert not far, f"(kernel, plain) from float64: {far}"
    else:
        assert_step_close(got, want, kw["msg_norm"])
    for name, gr in got[4].items():
        assert torch.equal(gr, again[4][name]), f"{name}: bits differ"
    for a, b in zip(got[:2], again[:2]):
        assert torch.equal(a, b), "forward: bits differ"
    assert _route_matches(shape, route), shape.tag()
    return shape


FWD_CASES = [
    # the forward kernels on every route of their rule: one cluster of 1,
    # 2, 4 and 8 blocks, the grid, 16-node tiles (spilled) and graphs past
    # a block's tile; T 1 and 32, 64 vocab ids, none/none, bn1d/stateless,
    # the ragged g 37 batch
    ("bn1d", "bn1d", 16, None, 6, 8, 0, "cluster 1"),
    ("bn1d", "bn1d", 16, None, 6, 8, 0, "cluster 2"),
    ("bn1d", "stateless", 16, None, 6, 8, 0, "cluster 4"),
    ("bn1d", "bn1d", 16, None, 6, 8, 0, "cluster 8"),
    ("none", "stateless", 16, None, 6, 8, 0, "grid"),
    ("bn1d", "bn1d", 1024, None, 6, 8, 0, "grid"),
    ("bn1d", "stateless", 1024, None, 6, 8, 0, "cluster 8"),
    ("bn1d", "bn1d", 37, None, 6, 8, 0, "spilled"),
    ("none", "none", 37, None, 6, 8, 0, "cluster 2"),
    ("none", "none", 1024, None, 6, 8, 0, "grid"),
    ("bn1d", "bn1d", 64, None, 1, 8, 0, "cluster 4"),
    ("bn1d", "stateless", 64, None, 32, 8, 0, "grid"),
    ("bn1d", "bn1d", 64, None, 6, 64, 0, "cluster 8"),
    ("bn1d", "bn1d", 20, None, 6, 8, 300, "spilled"),
    ("bn1d", "bn1d", 4, None, 3, 8, 600, "grid"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "msg_norm,state_norm,g,route,steps,k,big,fwd",
    [c + (None,) for c in [
     ("bn1d", "bn1d", 1024, None, 6, 8, 0),
     ("bn1d", "none", 1024, None, 6, 8, 0),
     ("none", "bn1d", 1024, None, 6, 8, 0),
     ("none", "none", 1024, None, 6, 8, 0),
     ("bn1d", "bn1d", 37, None, 6, 8, 0),
     ("none", "stateless", 1024, None, 6, 8, 0),
     ("bn1d", "stateless", 1024, None, 6, 8, 0),
     ("none", "stateless", 37, None, 6, 8, 0),
     # every route of the backward's rule
     ("bn1d", "bn1d", 16, "cluster 1", 6, 8, 0),
     ("bn1d", "bn1d", 16, "cluster 2", 6, 8, 0),
     ("bn1d", "bn1d", 16, "cluster 4", 6, 8, 0),
     ("bn1d", "bn1d", 16, "cluster 8", 6, 8, 0),
     ("bn1d", "bn1d", 16, "grid", 6, 8, 0),
     ("bn1d", "bn1d", 1024, "cluster 8", 6, 8, 0),
     ("bn1d", "bn1d", 1024, "spilled", 6, 8, 0),
     ("none", "none", 16, "cluster 4", 6, 8, 0),
     ("bn1d", "stateless", 37, "spilled", 6, 8, 0),
     ("bn1d", "none", 100, None, 6, 8, 0),
     # T 1 and 32, 64 vocab ids, one graph, a graph past a block's tile
     ("bn1d", "bn1d", 64, None, 1, 8, 0),
     ("bn1d", "stateless", 64, None, 32, 8, 0),
     ("bn1d", "stateless", 64, "grid", 32, 8, 0),
     ("bn1d", "bn1d", 64, None, 6, 64, 0),
     ("none", "none", 1, None, 6, 8, 0),
     ("none", "none", 1, None, 6, 8, 300),
     ("bn1d", "bn1d", 20, None, 6, 8, 300),
     ("bn1d", "bn1d", 20, "cluster 1", 6, 8, 260),
     ("none", "stateless", 20, "grid", 6, 8, 260),
     ("none", "none", 4, "grid", 3, 8, 600)]] + FWD_CASES)
def test_cuda_step_kernels_match_plain_version(msg_norm, state_norm, g,
                                               route, steps, k, big, fwd):
    """Flagship widths (f 10, od 14): the forward kernel against
    fused_step_reference, the backward kernel against autograd through it,
    with the cotangents of both the loss and out nonzero; the stateless
    state norm's statistics and closed-form VJP too. g = 37 is a ragged
    batch: single-atom graphs, padded edges, a padded graph slot. The
    backward on every route of its rule (`route`, else the rule's: with a
    state norm one cluster up to CLUSTER_SLOTS node slots, the grid past
    them — g = 100 —, without one the grid at every size), at T 1
    and 32, with 64 vocab ids, on one graph (no norms: under a batch norm
    one graph's ∂A0 and ∂mbias are batch-wide sums that cancel to rounding
    on both sides), and with a graph of `big` nodes, past a block's
    shared-memory tile (up to 600 nodes); each twice, the same bits. With
    `fwd`, the forward kernels on that forced route (FWD_CASES): their
    stash (padded slots zero) against the plain version's, and the
    stateless serving kernel against fused_eval_reference."""
    _need_card()
    rng = np.random.RandomState(
        g if (steps, k, big) == (6, 8, 0) else 7 * g + steps + k + big)
    args, leaves = _step_problem(rng, g, k=k, big=big)
    cw = torch.as_tensor(rng.randn(g, 14).astype(np.float32), device="cuda")
    shape = _step_case(args, leaves, cw, route, 14, steps=steps,
                       msg_norm=msg_norm, state_norm=state_norm, fwd=fwd)
    if g == 100:
        assert shape.route == "grid", shape.tag()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "msg_norm,state_norm,g,route,steps,big,fwd",
    [("none", "bn1d", 64, None, 32, 0, None),
     ("none", "bn1d", 64, "grid", 32, 0, None),
     ("none", "none", 4, None, 3, 4000, None),
     ("bn1d", "bn1d", 4, None, 6, 4000, None),
     ("bn1d", "bn1d", 4, "cluster 8", 6, 4000, None),
     # the forward kernels in one block, a 600-node graph past its tile,
     # the stateless norm without a message norm
     ("none", "stateless", 4, None, 3, 600, "cluster 1")])
def test_cuda_step_kernels_against_float64(msg_norm, state_norm, g, route,
                                           steps, big, fwd):
    """Batches where float32 in any summation order sits past 1e-5 of the
    exact gradients, so that the plain float32 version is no yardstick at
    that tolerance: T 32 without a message norm, a 4,000-node graph on
    the grid and on a cluster, and the forward kernels forced into one
    block with a 600-node graph (`fwd`: their stash also held to the
    plain version's, as test_cuda_step_kernels_match_plain_version holds
    it). Every output and leaf is held to the float64 answer (within 1e-5
    of its max abs, or no further than the plain float32 version is); one
    launch each way, the same bits twice."""
    _need_card()
    rng = np.random.RandomState(7 * g + steps + 8 + big)
    args, leaves = _step_problem(rng, g, big=big)
    cw = torch.as_tensor(rng.randn(g, 14).astype(np.float32), device="cuda")
    _step_case(args, leaves, cw, route, 14, exact=True, steps=steps,
               msg_norm=msg_norm, state_norm=state_norm, fwd=fwd)


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
    with pytest.raises(NotImplementedError, match="bn1d-only"):
        K.fused_step(*args, steps=6, state_norm="stateless", bwd="split")
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
    with pytest.raises(NotImplementedError, match="widths up to"):
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


def s2v_sizes_problem(rng, sizes, w=14, pad=5, device="cuda"):
    """set2vec's arguments on graphs of the given node counts (0 for an
    empty graph), `pad` padded node slots after them: a random masked x
    (N, w) and readout leaves in the JAX layout, each requiring grad."""
    sizes = np.asarray(sizes, np.int64)
    g, n_real = len(sizes), int(sizes.sum())
    n = n_real + pad
    ng = np.full(n, g, np.int32)
    ng[:n_real] = np.repeat(np.arange(g), sizes)
    gnp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    i = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    mask = t((np.arange(n) < n_real)[:, None])
    b = 1.0 / np.sqrt(2 * w)
    u = lambda *s_: t(rng.uniform(-b, b, s_))
    rp = {"lstm": {**{f"w_h{k}": u(2 * w, w) for k in "ifgo"},
                   **{f"b_h{k}": u(1, w) for k in "ifgo"}},
          "q_attn": {"w": t(rng.uniform(-1, 1, (w, w)) / np.sqrt(w))},
          "e_attn": {"w": t(rng.uniform(-1, 1, (w, 1)) / np.sqrt(w))}}
    x = t(rng.randn(n, w)) * mask
    leaves = {**{f"lstm/{k}": v for k, v in rp["lstm"].items()},
              "q_attn": rp["q_attn"]["w"], "e_attn": rp["e_attn"]["w"],
              "x": x}
    for v in leaves.values():
        v.requires_grad_(True)
    return (rp, x, mask, i(ng), i(gnp)), leaves


def s2v_cases():
    """set2vec's routes on the card as (id, graph sizes, w, steps, the
    forward's and the backward's S2vShape.tag): bench.py-like ragged
    graphs of 1 to 24 nodes (the first three single-node), at b16, 24 (one
    block of 16 warps: two graphs a warp) and b1024; 40 graphs of which
    three hold 4,000 nodes, past a block's staging capacity, at w 14 and
    54; w 54 and 64 at b16 and 300 graphs, the graphs of one block empty;
    6,000 graphs at w 32 (the backward's leaf sums in global scratch);
    2,048 graphs at w 54 (adv's training batch at afm 27: the backward's
    slots in global scratch) and 10,000 at w 64 (both kernels' slots)."""
    rng = np.random.RandomState(5)
    ragged = lambda g: np.concatenate([[1, 1, 1], rng.randint(1, 25, g - 3)])
    big = ragged(40)
    big[[7, 20, 33]] = 4000
    wide = ragged(300)
    wide[11:13] = 0              # a block of 2-3 graphs on 132 SMs: empty
    one, grid = ("one-block",) * 2, ("grid",) * 2
    chunked = ("grid chunked", "grid chunked")
    wide_b16 = ("one-block", "grid global-acc")
    wide_grid = ("grid", "grid global-acc")
    return [("b16", ragged(16), 14, 100, one),
            ("g24", ragged(24), 14, 20, one),
            ("b1024", ragged(1024), 14, 100, grid),
            ("chunked", big, 14, 20, chunked),
            ("b16-w54", ragged(16), 54, 20, wide_b16),
            ("b16-w64", ragged(16), 64, 20, wide_b16),
            ("g300-w54-empty-block", wide, 54, 20, wide_grid),
            ("g300-w64-empty-block", wide, 64, 20, wide_grid),
            ("chunked-w54", big, 54, 20,
             ("grid chunked", "grid chunked global-acc")),
            ("g6000-w32", ragged(6000), 32, 20,
             ("grid", "grid chunked global-acc")),
            ("g2048-w54", ragged(2048), 54, 20,
             ("grid", "grid chunked global-acc spilled")),
            ("g10000-w64", ragged(10000), 64, 20,
             ("grid chunked spilled", "grid chunked global-acc spilled"))]


@pytest.mark.gpu
@pytest.mark.parametrize("batch_softmax", [True, False])
@pytest.mark.parametrize("case", range(len(s2v_cases())),
                         ids=[c[0] for c in s2v_cases()])
def test_cuda_set2vec_kernels_match_plain_version(batch_softmax, case):
    """Every route of the set2vec kernels (kernels/set2vec.py::
    launch_shape: one block, a block per SM, rows streamed in chunks, the
    backward's leaf sums or both kernels' slots in global scratch) in both
    softmax modes at w 14, 32, 54 and 64: the forward kernel against
    set2vec_reference, the backward against autograd through it (leaves
    scaled by their max abs), one launch of each."""
    _need_card()
    from mpnn_tpu_torch.kernels import set2vec as S
    name, sizes, w, steps, tags = s2v_cases()[case]
    rng = np.random.RandomState(case + 10 * batch_softmax)
    args, leaves = s2v_sizes_problem(rng, sizes, w=w)
    n, g = args[1].shape[0], len(sizes)
    ptr = args[4].cpu().numpy()
    assert tuple(S.device_shape(d, n, g, w, "cuda").tag(ptr)
                 for d in ("fwd", "bwd")) == tags
    cw = torch.as_tensor(rng.randn(g, 2 * w).astype(np.float32),
                         device="cuda")
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
    with pytest.raises(NotImplementedError, match="widths up to"):
        A.fused_att(*wide)
    s_args, _ = _s2v_problem(np.random.RandomState(11), 16,
                             w=S.MAX_WIDTH + 2)
    with pytest.raises(NotImplementedError, match="widths up to"):
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


# ---------------------------------------------------------------------------
# the T-step attention family's kernels (fused_att_steps_fwd.cu,
# fused_att_steps_bwd.cu)
# ---------------------------------------------------------------------------

def _atts_problem(rng, g, f=7, k=8, tm=3, device="cuda"):
    """fused_att_steps' arguments on a _problem batch (ragged graphs,
    padded edges on the dummy node with vid 0, whose A' is NOT zero) with
    Tm random message tables, and {leaf: tensor} of its differentiable
    arguments, each requiring grad."""
    (_, _, _, h0, mask, ng, gru, _, _, _, _, _, vid, src, dst,
     plan) = _problem(rng, g=g, f=f, od=4, k=k, device=device)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    w = {"aprime": t(rng.randn(tm, k, f, f) * 0.3),
         "a0": t(rng.randn(tm, f, f) * 0.3), "qv": t(rng.randn(tm, k, f)),
         "q0": t(rng.randn(tm, f)), "wh": t(rng.randn(tm, f, f) * 0.5)}
    leaves = {**w, "h0": h0, **{f"gru/{n}": v for n, v in gru.items()}}
    for x in leaves.values():
        x.requires_grad_(True)
    args = (w["aprime"], w["a0"], w["qv"], w["q0"], w["wh"], h0, mask, ng,
            gru, vid, src, dst, plan)
    return args, leaves


@pytest.mark.gpu
@pytest.mark.parametrize("per_step,state_norm,with_corr,g,f", [
    (True, "stateless", False, 1024, 7), (True, "none", False, 1024, 7),
    (False, "stateless", False, 1024, 7), (True, "stateless", True, 1024, 7),
    (True, "stateless", False, 37, 7), (True, "stateless", True, 37, 16),
    (False, "none", True, 37, 12)])
def test_cuda_att_steps_kernels_match_plain_version(per_step, state_norm,
                                                    with_corr, g, f):
    """The att model's widths (f 7, T 3): the forward kernel against
    fused_att_steps_reference, the backward against autograd through it,
    in the four modes (per-step or shared tables, the stateless norm or
    none, 'adj' or 'att') at batch 1024 and on ragged batches of 37; and
    the f <= 16 builds (f 16 and 12). Then the serving launch (no grad:
    no residuals) against the same output."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    rng = np.random.RandomState(g + f + 2 * per_step + with_corr)
    args, leaves = _atts_problem(rng, g, f=f, tm=3 if per_step else 1)
    cw = torch.as_tensor(rng.randn(*args[5].shape).astype(np.float32),
                         device="cuda")
    kw = dict(steps=3, with_corr=with_corr, state_norm=state_norm)
    AS.reset_launch_counts()
    got = _value_and_grads(AS.fused_att_steps, args, leaves, cw, **kw)
    torch.cuda.synchronize()
    assert AS.launch_counts == {"fused_att_steps_fwd": 1,
                                "fused_att_steps_bwd": 1}
    want = _value_and_grads(AS.fused_att_steps_reference, args, leaves, cw,
                            **kw)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert all(torch.isfinite(x).all() for x in got[1].values())
    _grads_close(got[1], want[1])
    with torch.no_grad():
        h = AS.fused_att_steps(*args, **kw)
    assert AS.launch_counts["fused_att_steps_fwd"] == 2
    torch.testing.assert_close(h, want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_att_steps_wrapper_raises_instead_of_falling_back():
    _need_card()
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    args, _ = _atts_problem(np.random.RandomState(13), 64)
    args = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
    AS.reset_launch_counts()
    bad = list(args)
    bad[0] = args[0].transpose(2, 3)                  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        AS.fused_att_steps(*bad, steps=3)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(TypeError, match="float32"):
        AS.fused_att_steps(*bad, steps=3)
    with pytest.raises(ValueError, match="3 message tables for 2 steps"):
        AS.fused_att_steps(*args, steps=2)
    wide, _ = _atts_problem(np.random.RandomState(14), 8,
                            f=AS.MAX_WIDTH + 1)
    with pytest.raises(NotImplementedError, match="widths up to"):
        AS.fused_att_steps(*wide, steps=3)
    deep, _ = _atts_problem(np.random.RandomState(15), 8,
                            tm=AS.MAX_STEPS + 1)
    with pytest.raises(NotImplementedError, match="steps"):
        AS.fused_att_steps(*deep, steps=AS.MAX_STEPS + 1)
    assert set(AS.launch_counts.values()) == {0}
    # the wide bucket's backward at the largest vocab and depth: its staged
    # gate tables need more than a block's shared memory (the forward fits)
    big, _ = _atts_problem(np.random.RandomState(16), 8, f=32, k=64,
                           tm=AS.MAX_STEPS)
    h = AS.fused_att_steps(*big, steps=AS.MAX_STEPS)
    with pytest.raises(NotImplementedError, match="shared memory"):
        h.sum().backward()
    assert AS.launch_counts == {"fused_att_steps_fwd": 1,
                                "fused_att_steps_bwd": 0}


@pytest.mark.gpu
def test_att_serving_path_on_card():
    """predict of the att model on cuda (one fused_att_steps_fwd and one
    set2vec_fwd launch per request) against the plain model on cuda,
    batch by batch."""
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
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
    cfg = zoo.att(ge.atom_width(), ge.bond_width(), n_out=4)
    net = network_init(cfg, torch.Generator().manual_seed(0), device)
    loader = G.GraphLoader(gs, 16)
    AS.reset_launch_counts()
    S.reset_launch_counts()
    got = np.concatenate(list(predict_batches(net, "ce", loader, device)))
    assert AS.launch_counts == {"fused_att_steps_fwd": len(loader),
                                "fused_att_steps_bwd": 0}
    assert S.launch_counts == {"set2vec_fwd": len(loader),
                               "set2vec_bwd": 0}
    with torch.no_grad():
        want = np.concatenate([
            network_apply_packed(net, batch_to_device(b, device),
                                 fused=False).cpu().numpy()
            for b in loader])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the wide width buckets (f <= 32, od <= 128, set2vec w <= 64) of every
# family, and the edge-MLP chain kernels (edge_mlp_fwd.cu, edge_mlp_bwd.cu)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("f,od,msg_norm,state_norm,route", [
    (24, 48, "bn1d", "bn1d", None), (32, 64, "bn1d", "bn1d", None),
    (7, 28, "none", "none", None), (7, 28, "bn1d", "stateless", None),
    (27, 108, "none", "none", None), (32, 128, "bn1d", "stateless", None),
    (27, 108, "none", "stateless", None),
    (7, 28, "none", "none", "cluster 1"), (7, 28, "bn1d", "bn1d", "grid"),
    (7, 28, "bn1d", "stateless", "spilled"),
    (32, 64, "bn1d", "bn1d", "cluster 2"), (24, 48, "bn1d", "none", "grid"),
    (30, 60, "none", "stateless", "spilled"),
    (27, 108, "none", "none", "cluster 8"),
    (32, 128, "bn1d", "stateless", "grid"),
    (27, 108, "bn1d", "bn1d", "spilled")])
def test_cuda_shared_family_wide_bucket(f, od, msg_norm, state_norm, route):
    """Rows 1-3 past the narrow bucket: lipo's widths past 16 (od =
    2·afm), the basic shell's od = 4·afm at afm 7 (the f 16 / od 64
    bucket) and afm 27-32 (the od-128 bucket), in both state-norm modes:
    the eval kernel and the training kernels against their plain
    versions, ragged batch; the backward on each route of its rule in
    every bucket, each twice for the same bits."""
    _need_card()
    rng = np.random.RandomState(f + od + (len(route) if route else 0))
    args = _problem(rng, g=300, f=f, od=od, k=12)
    kw = dict(steps=3, msg_norm=msg_norm, state_norm=state_norm)
    K.reset_launch_counts()
    got = K.fused_eval(*args, **kw)
    want = K.fused_eval_reference(*args, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    sargs, leaves = _step_problem(rng, 300, f=f, od=od, k=12)
    cw = torch.as_tensor(rng.randn(300, od).astype(np.float32),
                         device="cuda")
    stateless = state_norm == "stateless"
    assert K.launch_counts == {"fused_eval": int(not stateless),
                               "fused_eval_stateless": int(stateless),
                               "fused_step_fwd": 0, "fused_step_bwd": 0}
    _step_case(sargs, leaves, cw, route, od, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("f,od,state_norm", [(24, 96, "stateless"),
                                             (32, 128, "bn1d")])
def test_cuda_psteps_wide_bucket(f, od, state_norm):
    """Rows 13 and 14a at graph_norm's od = 4·afm: serving and training
    against the plain versions."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_psteps as P
    rng = np.random.RandomState(f + od)
    c, leaves = _ps_problem(rng, 300, f=f, od=od, k=12)
    kw = dict(steps=3, msg_norm="bn1d", state_norm=state_norm)
    P.reset_launch_counts()
    with torch.no_grad():
        got = _ps_eval(P.fused_psteps_eval, c, **kw)
        want = _ps_eval(P.fused_psteps_eval_reference, c, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    cw = torch.as_tensor(rng.randn(300, od).astype(np.float32),
                         device="cuda")
    got = ps_step_and_grads(P.fused_psteps, c, leaves, cw, **kw)
    torch.cuda.synchronize()
    assert P.launch_counts == {"fused_psteps_eval": 1, "fused_psteps_fwd": 1,
                               "fused_psteps_bwd": 1}
    want = ps_step_and_grads(P.fused_psteps_reference, c, leaves, cw, **kw)
    assert_ps_close(got, want, "bn1d")


@pytest.mark.gpu
@pytest.mark.parametrize("f", [24, 32])
def test_cuda_attention_wide_buckets(f):
    """Rows 15, 16 at f 24 and 32 and row 12 at w = 2f (48, 64): each
    family's forward and backward kernels against the plain versions."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import set2vec as S
    rng = np.random.RandomState(f)
    for mod, fn, ref, (args, leaves), kw in [
            (A, A.fused_att, A.fused_att_reference,
             _att_problem(rng, 300, f=f, k=12), dict(with_corr=True)),
            (AS, AS.fused_att_steps, AS.fused_att_steps_reference,
             _atts_problem(rng, 300, f=f, k=12), dict(steps=3)),
            (S, S.set2vec, S.set2vec_reference,
             _s2v_problem(rng, 300, w=2 * f),
             dict(time_steps=20, batch_softmax=True))]:
        out_shape = (args[1] if mod is S else args[5]).shape
        cw = torch.as_tensor(rng.randn(300 if mod is S else out_shape[0],
                                       2 * out_shape[1] if mod is S
                                       else out_shape[1]).astype(np.float32),
                             device="cuda")
        mod.reset_launch_counts()
        got = _value_and_grads(fn, args, leaves, cw, **kw)
        torch.cuda.synchronize()
        assert sorted(mod.launch_counts.values()) == [1, 1], mod.launch_counts
        want = _value_and_grads(ref, args, leaves, cw, **kw)
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
        _grads_close(got[1], want[1])


def mlp_chain(rng, rows, head, tail):
    """An edge-MLP chain's rows (the last the zero row), head weights and
    biases in the JAX layout and W_s, numpy float32. W_s = s·(0.7·I +
    0.3·Q), Q a random rotation, s the first scale that keeps the output
    after the tail within 0.3-30: the relus cut about half the features
    and float32 rounding stays near 1e-6 over 50 steps (a pure rotation,
    measured against float64, amplifies it to 1e-4)."""
    pf = head[-1][1]
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    x = f(rows, head[0][0])
    x[-1] = 0.0
    ws = [f(i, o, sc=1 / np.sqrt(i)) for i, o in head]
    bs = [f(o, sc=0.1) for _, o in head]
    base = 0.7 * np.eye(pf) + 0.3 * np.linalg.qr(rng.randn(pf, pf))[0]
    for scale in np.arange(0.9, 2.0, 0.05):
        h = x
        for w, b in zip(ws, bs):
            h = np.maximum(h @ w + b, 0.0)
        for _ in range(tail):
            h = np.maximum(h @ (scale * base), 0.0)
        if 0.3 <= np.abs(h).max() <= 30:
            break
    return x, ws, bs, (scale * base).astype(np.float32)


def _mlp_problem(rng, rows, head, tail, device="cuda"):
    """mlp_chain's arrays as tensors on `device`, each requiring grad."""
    t = lambda a: torch.as_tensor(a, device=device).requires_grad_()
    x, ws, bs, sw = mlp_chain(rng, rows, head, tail)
    return t(x), [t(w) for w in ws], [t(b) for b in bs], t(sw)


# (rows, head, tail, the routes of kernels/edge_mlp.py::launch_shape on an
# H100, forward / backward): the register route in one block (the zero row
# alone; the backward's 4 rows) and in several (pf 16-64, 4 to 200 rows),
# no tail; the
# panel route in one block (pf 81), in clusters of 2 and 4 (pf 144, 256),
# 17 and 50 clusters; the l2 route (W_s and the backward's stash in device
# memory) past what a cluster of 8 holds: bond widths 22, 25 (and 5 at
# f 26) and 31 at f > ef give pf 484, 625 and 961
MLP_ROUTE_CASES = [
    (9, [(2, 4), (4, 16)], 50, "reg C1 rb2 x5", "reg C1 rb3 x3"),
    (9, [(6, 36)], 50, "reg C1 rb2 x5", "reg C1 rb3 x3"),
    (4, [(6, 36)], 50, "reg C1 rb2 x2", "reg C1 rb4 x1"),
    (65, [(7, 49)], 50, "reg C1 rb2 x33", "reg C1 rb4 x17"),
    (65, [(8, 64)], 50, "reg C1 rb2 x33", "reg C1 rb4 x17"),
    (1, [(6, 36)], 50, "reg C1 rb1 x1", "reg C1 rb1 x1"),
    (200, [(6, 36)], 50, "reg C1 rb2 x100", "reg C1 rb4 x50"),
    (5, [(6, 36)], 0, "reg C1 rb2 x3", "reg C1 rb3 x2"),
    (65, [(3, 9), (9, 81)], 50, "panel C1 rb4 x17", "panel C1 rb4 x17"),
    (65, [(12, 144)], 50, "panel C1 rb4 x17", "panel C2 rb4 x17"),
    (65, [(4, 16), (16, 256)], 50, "panel C2 rb4 x17", "panel C4 rb4 x17"),
    (200, [(4, 16), (16, 256)], 50, "panel C2 rb4 x50", "panel C4 rb4 x50"),
    (9, [(22, 484)], 50, "panel C8 rb3 x3", "l2 C8 rb3 x3"),
    (9, [(5, 25), (25, 625)], 50, "l2 C8 rb3 x3", "l2 C8 rb3 x3"),
    (65, [(31, 961)], 50, "l2 C8 rb5 x13", "l2 C8 rb4 x17"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,head,tail,fwd_route,bwd_route",
                         MLP_ROUTE_CASES)
def test_cuda_edge_mlp_kernels_match_plain_version(rows, head, tail,
                                                   fwd_route, bwd_route):
    """The chain on every route of the launch rule (pf 16 to 961, R 1 to
    200, clusters of 1 to 8, no tail): the forward kernel against
    edge_mlp_reference and the backward against autograd through it,
    every input's gradient; one launch each; the built libraries' shared
    memory equal to the rule's; a second run gives the same bits (the
    backward's cross-block counters reset themselves)."""
    _need_card()
    from mpnn_tpu_torch.kernels import edge_mlp as M
    rng = np.random.RandomState(rows + tail)
    x, ws, bs, sw = _mlp_problem(rng, rows, head, tail)
    dims = [head[0][0]] + [o for _, o in head]
    for direction, route in (("fwd", fwd_route), ("bwd", bwd_route)):
        shape = M.device_shape(direction, rows, dims, tail, x.device)
        assert shape.tag() == route
        assert M.library_smem_bytes(direction, rows, dims, tail,
                                    shape) == shape.smem_bytes
    leaves = {"x": x, **{f"w{i}": w for i, w in enumerate(ws)},
              **{f"b{i}": b for i, b in enumerate(bs)}, "ws": sw}
    cw = torch.as_tensor(rng.randn(rows, sw.shape[0]).astype(np.float32),
                         device="cuda")
    M.reset_launch_counts()
    got = _value_and_grads(M.edge_mlp, (x, ws, bs, sw), leaves, cw,
                           tail=tail)
    torch.cuda.synchronize()
    assert M.launch_counts == {"edge_mlp_fwd": 1, "edge_mlp_bwd": 1}
    again = _value_and_grads(M.edge_mlp, (x, ws, bs, sw), leaves, cw,
                             tail=tail)
    assert torch.equal(again[0], got[0])
    assert all(torch.equal(again[1][k], got[1][k]) for k in got[1])
    want = _value_and_grads(M.edge_mlp_reference, (x, ws, bs, sw), leaves,
                            cw, tail=tail)
    scale = float(want[0].abs().max())       # the chain's scale varies
    assert scale > 0
    torch.testing.assert_close(got[0] / scale, want[0] / scale, rtol=RTOL,
                               atol=ATOL)
    _grads_close(got[1], want[1])


@pytest.mark.gpu
def test_cuda_edge_mlp_wrapper_raises_instead_of_falling_back():
    _need_card()
    from mpnn_tpu_torch.kernels import edge_mlp as M
    x, ws, bs, sw = _mlp_problem(np.random.RandomState(0), 9, [(6, 36)], 3)
    x, ws, bs, sw = x.detach(), [w.detach() for w in ws], [
        b.detach() for b in bs], sw.detach()
    M.reset_launch_counts()
    with pytest.raises(ValueError, match="is on cpu"):
        M.edge_mlp(x, ws, bs, sw.cpu(), tail=3)
    with pytest.raises(TypeError, match="float32"):
        M.edge_mlp(x, ws, [bs[0].double()], sw, tail=3)
    with pytest.raises(ValueError, match="shape"):
        M.edge_mlp(x, ws, bs, sw[:, :20], tail=3)
    with pytest.raises(NotImplementedError, match="5 head layers"):
        M.edge_mlp(x, ws * 5, bs * 5, sw, tail=3)
    assert set(M.launch_counts.values()) == {0}


@pytest.mark.gpu
def test_cuda_edge_mlp_backward_from_two_threads():
    """The backward kernel's shared-memory limit belongs to the kernel, not
    to a host thread: autograd launches the backward at T 50 from its own
    thread, this thread a prepared backward of the same kernel at T 3 (a
    smaller stash), then autograd the T-50 backward again. No launch may
    lower the limit below the size another thread's launch relies on; the
    last run gives the first's bits and matches the plain version."""
    _need_card()
    from mpnn_tpu_torch.kernels import edge_mlp as M
    rng = np.random.RandomState(17)
    x, ws, bs, sw = _mlp_problem(rng, 9, [(6, 36)], 50)
    dims = [6, 36]
    big, small = (M.device_shape("bwd", 9, dims, t, x.device)
                  for t in (50, 3))
    assert (big.kp, big.cluster, big.route) == (small.kp, small.cluster,
                                               small.route)
    assert big.smem_bytes > small.smem_bytes
    leaves = {"x": x, "w0": ws[0], "b0": bs[0], "ws": sw}
    cw = torch.as_tensor(rng.randn(9, 36).astype(np.float32), device="cuda")
    first = _value_and_grads(M.edge_mlp, (x, ws, bs, sw), leaves, cw,
                             tail=50)
    detached = [t.detach() for t in (x, ws[0], bs[0], sw)]
    K.launch_prepared(M.prepare_edge_mlp_bwd(
        detached[0], [detached[1]], [detached[2]], detached[3],
        torch.ones(9, 36, device="cuda"), tail=3))
    M.reset_launch_counts()
    again = _value_and_grads(M.edge_mlp, (x, ws, bs, sw), leaves, cw,
                             tail=50)
    torch.cuda.synchronize()
    assert M.launch_counts == {"edge_mlp_fwd": 1, "edge_mlp_bwd": 1}
    assert torch.equal(again[0], first[0])
    assert all(torch.equal(again[1][k], first[1][k]) for k in first[1])
    want = _value_and_grads(M.edge_mlp_reference, (x, ws, bs, sw), leaves,
                            cw, tail=50)
    scale = float(want[0].abs().max())
    torch.testing.assert_close(again[0] / scale, want[0] / scale,
                               rtol=RTOL, atol=ATOL)
    _grads_close(again[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["lipo", "graph_norm", "adv", "att"])
def test_wide_model_paths_on_card(model):
    """Serving through the kernels at afm 27 (SMILES with many atom types
    and charges): one edge-MLP forward launch per message network per
    request, the output equal to the plain model on the card."""
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train.cli import predict_batches
    from mpnn_tpu_torch.train.trainer import batch_to_device
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(
        WIDE_SMILES, [0] * len(WIDE_SMILES)))
    assert ge.atom_width() == 27
    cfg = (zoo.lipo(ge.atom_width(), ge.bond_width(), 3) if model == "lipo"
           else zoo.build(model, afm=ge.atom_width(), bfm=ge.bond_width(),
                          nafm=3, n_out=4))
    net = network_init(cfg, torch.Generator().manual_seed(0), device)
    loader = G.GraphLoader(gs, 16, collate="packed")
    M.reset_launch_counts()
    task = "mse" if model == "lipo" else "ce"
    got = np.concatenate([o.reshape(-1) for o in
                          predict_batches(net, task, loader, device)])
    assert M.launch_counts == {
        "edge_mlp_fwd": len(loader) * len(net.mpnn.message),
        "edge_mlp_bwd": 0}
    with torch.no_grad():
        want = np.concatenate([
            network_apply_packed(net, batch_to_device(b, device),
                                 fused=False).reshape(-1).cpu().numpy()
            for b in loader])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# drug-like SMILES over many elements, charges and aromatic rings: they
# featurize to afm 27 and bfm 6, so lipo's f is 30 and od 54, graph_norm's
# od 108, adv's and att's f 27 and set2vec's w 54 (chip_smoke.py's wide
# phase takes the same list)
WIDE_SMILES = [
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O=C(O)c1ccccc1OC(C)=O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "C1=CC=C(C=C1)[N+](=O)[O-]",
    "FC(F)(F)c1ccc(Cl)cc1Br", "Ic1ccc(cc1)S(=O)(=O)N", "CP(=O)(O)O",
    "B(O)(O)c1ccccc1", "C[Si](C)(C)OC", "[Na+].[Cl-]", "C[Se]C",
    "[NH4+]", "O=[As](O)(O)O", "[K+].[I-]", "c1ccc2[nH]ccc2c1",
    "C1CCNCC1", "OC[C@H]1OC(O)[C@H](O)[C@@H](O)[C@@H]1O", "[Li+].[F-]",
    "[Mg+2].[O-]C(=O)C", "Cl[Sn](Cl)(Cl)Cl", "[Zn+2]", "[Ca+2]",
    "[Al](Cl)(Cl)Cl",
] * 3


# ---------------------------------------------------------------------------
# the bilinear family (ecfp_bilinear) and the ECFP task (encoded_ecfp)
# ---------------------------------------------------------------------------

def bil_problem(rng, g, f=2, k=8, device="cuda"):
    """fused_bilinear's arguments on a _problem batch (ragged graphs of 1
    to 24 nodes, self-loops among the random edges, padded edges on the
    dummy node with vid 0): a random non-symmetric A table (K, f, f²) with
    the zero row's A_0 = 0, h0 and the GRU leaves requiring grad.
    Returns (args, leaves)."""
    p = _problem(rng, g=g, f=f, k=k, device=device)
    amat = rng.randn(k, f, f * f).astype(np.float32) * 0.5
    amat[0] = 0.0
    h0, mask, ng, gru = p[3], p[4], p[5], p[6]
    leaves = {"h0": h0, **gru}
    for t in leaves.values():
        t.requires_grad_()
    args = (torch.as_tensor(amat, device=device), h0, mask, ng, gru,
            *p[12:16])
    return args, leaves


@pytest.mark.gpu
@pytest.mark.parametrize("g,f,steps", [(1024, 2, 1), (1024, 2, 2),
                                       (1024, 3, 3), (1024, 4, 2),
                                       (37, 2, 3), (37, 4, 1)])
def test_cuda_bilinear_kernels_match_plain_version(g, f, steps):
    """ecfp_bilinear's widths (f 2, T 2) and the rest of the bucket (f 2-4,
    T 1-3), at batch 1024 and on ragged batches of 37: the forward kernel
    against fused_bilinear_reference, the backward against autograd
    through it (cotangent Σ hist·c; h0 and GRU gradients each divided by
    their max abs; amat's zero), then the serving launch (no grad: no
    message stash) against the same output."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    rng = np.random.RandomState(g + 10 * f + steps)
    args, leaves = bil_problem(rng, g, f=f)
    cw = torch.as_tensor(rng.randn(args[1].shape[0], steps * f).astype(
        np.float32), device="cuda")
    B.reset_launch_counts()
    got = _value_and_grads(B.fused_bilinear, args, leaves, cw, steps=steps)
    torch.cuda.synchronize()
    assert B.launch_counts == {"fused_bilinear_fwd": 1,
                               "fused_bilinear_bwd": 1}
    want = _value_and_grads(B.fused_bilinear_reference, args, leaves, cw,
                            steps=steps)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert all(torch.isfinite(x).all() for x in got[1].values())
    _grads_close(got[1], want[1])
    amat = args[0].clone().requires_grad_()
    out = B.fused_bilinear(amat, *args[1:], steps=steps)
    out.sum().backward()
    assert amat.grad is not None and not amat.grad.any()
    with torch.no_grad():
        hist = B.fused_bilinear(*args, steps=steps)
    assert B.launch_counts == {"fused_bilinear_fwd": 3,
                               "fused_bilinear_bwd": 2}
    torch.testing.assert_close(hist, want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_bilinear_serving_writes_no_messages(monkeypatch):
    """Under no_grad the op prepares its forward without the message stash
    (a null pointer to the kernel), with grad it writes it."""
    _need_card()
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    args, _ = bil_problem(np.random.RandomState(3), 64)
    flavors = []
    real = B.prepare_fused_bilinear_fwd

    def spy(*a, **kw):
        p = real(*a, **kw)
        flavors.append((kw["write_msgs"], p.out[1].numel(), p.args[12]))
        return p
    monkeypatch.setattr(B, "prepare_fused_bilinear_fwd", spy)
    with torch.no_grad():
        B.fused_bilinear(*args, steps=2)
    B.fused_bilinear(*args, steps=2)
    n, f = args[1].shape
    assert flavors[0] == (False, 0, None)
    assert flavors[1][:2] == (True, n * 2 * f) and flavors[1][2]


@pytest.mark.gpu
def test_cuda_bilinear_wrapper_raises_instead_of_falling_back():
    _need_card()
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    args, _ = bil_problem(np.random.RandomState(5), 64)
    args = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
    B.reset_launch_counts()
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(TypeError, match="float32"):
        B.fused_bilinear(*bad, steps=2)
    bad = list(args)
    bad[0] = args[0].cpu()
    with pytest.raises(ValueError, match="amat is on cpu"):
        B.fused_bilinear(*bad, steps=2)
    wide, _ = bil_problem(np.random.RandomState(6), 8, f=B.MAX_WIDTH + 1)
    with pytest.raises(NotImplementedError, match="widths up to"):
        B.fused_bilinear(*wide, steps=2)
    # one graph past the shared-memory cap: a chain of 257 atoms
    n = B.MAX_GRAPH_NODES + 1
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    i = lambda x: torch.as_tensor(x, device="cuda")
    ng = np.zeros(n + 1, np.int32)
    ng[-1] = 1
    mask = torch.ones(n + 1, 1, device="cuda")
    mask[-1] = 0
    big = (args[0], torch.zeros(n + 1, 2, device="cuda"), mask, i(ng),
           args[4], i(np.ones(n - 1, np.int32)), i(src), i(dst),
           K.FusedEvalPlan(*(i(p) for p in plan_fused_eval(dst, ng, 1))))
    with pytest.raises(NotImplementedError, match="257 atoms"):
        B.fused_bilinear(*big, steps=2)
    assert set(B.launch_counts.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["encoded_ecfp", "ecfp_bilinear"])
def test_ecfp_models_on_card(model, tmp_path):
    """encoded_ecfp (per-step kernels, obn, the 16,384-bit head at nbits
    64 here) and ecfp_bilinear (the bilinear kernels, nbits 32 = its od,
    head 'none'): predict through the
    serving path against the plain model on the card, batch by batch, and
    3 Adam steps of ecfp_mse through the training kernels against the same
    steps on the plain path (losses rtol 1e-4)."""
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import fused_bilinear as B
    from mpnn_tpu_torch.kernels import fused_psteps as P
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import (network_apply_packed,
                                               network_init)
    from mpnn_tpu_torch.train.cli import predict_batches
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import batch_to_device, train_step
    csv = tmp_path / "x.csv"
    csv.write_text("smiles,target\n" + "".join(
        f"{s},0\n" for s in WIDE_SMILES[:23] * 2))
    nbits = 32 if model == "ecfp_bilinear" else 64
    gs, ge = G.load_ecfp_dataset(str(csv), "smiles", "target", nbits=nbits)
    if model == "ecfp_bilinear":
        from chip_smoke import bil_cut
        gs = bil_cut(gs)
        cfg = zoo.build(model, afm=2, bfm=8, n_out=32)
        counts = B.launch_counts
    else:
        cfg = zoo.build(model, afm=ge.atom_width(), bfm=ge.bond_width(),
                        n_out=64)
        counts = P.launch_counts
    net = network_init(cfg, torch.Generator().manual_seed(0), device)
    loader = G.GraphLoader(gs, 16, collate="packed")
    for k in counts:
        counts[k] = 0
    got = np.concatenate(list(predict_batches(net, "ecfp_mse", loader,
                                              device)))
    assert sum(counts.values()) == len(loader)
    with torch.no_grad():
        want = np.concatenate([
            network_apply_packed(net, batch_to_device(b, device),
                                 fused=False).cpu().numpy() for b in loader])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    losses = []
    for fused in (True, False):
        n = network_init(cfg, torch.Generator().manual_seed(0), device)
        opt = adam(n.parameters(), 1e-3, weight_decay=1e-5)
        losses.append([float(train_step(n, opt, batch_to_device(b, device),
                                        fused=fused, loss_kind="ecfp_mse"))
                       for b, _ in zip(loader, range(3))])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def spmm_problem(rng, g, f=10, k=8, device="cuda"):
    """The SpMM's arguments on a _problem batch (ragged graphs of 1 to 24
    nodes, padded edges on the dummy node with vid 0 and A_0 = 0): a
    random table A (K, f, f), h (N, f) zero on the padded rows, and a
    cotangent g (N, f). Returns (a, h, vid, src, dst, plan, g)."""
    p = _problem(rng, g=g, f=f, k=k, device=device)
    amat = rng.randn(k, f, f).astype(np.float32) * 0.3
    amat[0] = 0.0
    n = p[3].shape[0]
    cot = torch.as_tensor(rng.randn(n, f).astype(np.float32), device=device)
    return (torch.as_tensor(amat, device=device), p[3], *p[12:16], cot)


@pytest.mark.gpu
@pytest.mark.parametrize("g,f,k", [(1024, 10, 8), (1024, 30, 64),
                                   (37, 24, 17), (16, 16, 8),
                                   (2560, 10, 8)])
def test_cuda_spmm_kernels_match_plain_version(g, f, k):
    """spmm_fwd (the forward, and on Aᵀ through the source order the dh
    of the VJP) and spmm_da against the plain version under autograd, at
    lipo's bench widths, at f 30 with the full vocab (the wide bucket), on
    ragged batches and past 32k node slots (g 2560). dA and dh are divided
    by their max abs; padded edges add exactly nothing."""
    _need_card()
    from chip_smoke import spmm_value_and_grads
    from mpnn_tpu_torch.kernels import spmm as S
    rng = np.random.RandomState(g + f + k)
    c = spmm_problem(rng, g, f=f, k=k)
    S.reset_launch_counts()
    got = spmm_value_and_grads(S.spmm, *c)
    torch.cuda.synchronize()
    assert S.launch_counts == {"spmm_fwd": 2, "spmm_da": 1}
    want = spmm_value_and_grads(lambda *x: S.spmm_reference(*x[:5]), *c)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    _grads_close(dict(zip("ah", got[1:])), dict(zip("ah", want[1:])))
    # the padded edges (vid 0 on the dummy node) contribute exactly 0
    assert not got[0][-1].any() and not got[2][-1].any()


@pytest.mark.gpu
def test_cuda_spmm_vocab_sizes_in_turn():
    """One process launches the narrow bucket's forward at every vocab
    size from 64 down to 1, then at 64 again: the forward stages A in K KB
    of shared memory, and a launch at one K must not leave the kernel's
    shared-memory limit below a later, larger K's. Each within rtol/atol
    of the plain version."""
    _need_card()
    from mpnn_tpu_torch.kernels import spmm as S
    for k in [*range(S.MAX_VOCAB, 0, -1), S.MAX_VOCAB]:
        a, h, vid, src, dst, plan, _ = spmm_problem(
            np.random.RandomState(k), 5, f=10, k=max(k, 2))
        a = a[:k].contiguous()
        vid = vid.clamp(max=k - 1).contiguous()
        got = S.spmm(a, h, vid, src, dst, plan)
        torch.testing.assert_close(got, S.spmm_reference(a, h, vid, src,
                                                         dst),
                                   rtol=RTOL, atol=ATOL,
                                   msg=lambda m, k=k: f"K={k}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,steps", [(256, 10, 4), (16512, 10, 6),
                                       (16512, 30, 6), (32896, 10, 6),
                                       (300, 24, 3)])
def test_cuda_recurrence_kernels_match_plain_version(n, f, steps):
    """recurrence_fwd and recurrence_bwd against reference_recurrence under
    autograd: h_T, both statistics and every gradient leaf (each divided
    by its max abs) at b16-like, b1024 (16,512 slots) and 32,896 slots,
    f 10 and the wide bucket, a random mask; then the serving launch (no
    residuals) against the same h_T."""
    _need_card()
    from chip_smoke import rec_case, rec_value_and_grads
    from mpnn_tpu_torch.kernels import recurrence as R
    gen = torch.Generator().manual_seed(n + f + steps)
    args, leaves, g = rec_case(n, f, gen, "cuda")
    R.reset_launch_counts()
    got = rec_value_and_grads(R.recurrence, args, leaves, g, steps)
    torch.cuda.synchronize()
    assert R.launch_counts == {"recurrence_fwd": 1, "recurrence_bwd": 1}
    want = rec_value_and_grads(R.reference_recurrence, args, leaves, g,
                               steps)
    for x, y in zip(got[0], want[0]):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
    _grads_close(got[1], want[1])
    with torch.no_grad():
        served = R.recurrence(*args, steps=steps)[0]
    assert R.launch_counts == {"recurrence_fwd": 2, "recurrence_bwd": 1}
    torch.testing.assert_close(served, want[0][0], rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_recurrence_kernels_near_float64_past_init_scale():
    """At GRU weights N(0, 0.3²), past the model's init scale, six steps
    amplify float32 rounding: the kernels' h_T, statistics and gradient
    leaves (each divided by its max abs) within rtol/atol of a float64
    run of the plain chain, at b1024's 16,512 slots and f 30."""
    _need_card()
    from chip_smoke import (rec_case, rec_distances, rec_float64,
                            rec_value_and_grads)
    from mpnn_tpu_torch.kernels import recurrence as R
    gen = torch.Generator().manual_seed(16548)
    args, leaves, g = rec_case(16512, 30, gen, "cuda", weight_sd=0.3)
    got = rec_value_and_grads(R.recurrence, args, leaves, g, 6)
    ef, eg, ok = rec_distances(got, rec_float64(args, leaves, g, 6))
    assert ok, (ef, eg)


@pytest.mark.gpu
def test_cuda_spmm_recurrence_wrappers_raise_instead_of_falling_back():
    _need_card()
    from chip_smoke import rec_case
    from mpnn_tpu_torch.kernels import recurrence as R
    from mpnn_tpu_torch.kernels import spmm as S
    a, h, vid, src, dst, plan, _ = spmm_problem(np.random.RandomState(1),
                                                 32)
    S.reset_launch_counts()
    R.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        S.spmm(a.double(), h, vid, src, dst, plan)
    with pytest.raises(ValueError, match="a is on cpu"):
        S.spmm(a.cpu(), h, vid, src, dst, plan)
    with pytest.raises(ValueError, match="vid out of range"):
        S.spmm(a, h, vid + 8, src, dst, plan)
    wide = spmm_problem(np.random.RandomState(2), 8, f=S.BUCKETS[-1][1]["f"]
                        + 1)
    with pytest.raises(NotImplementedError, match="f=33"):
        S.spmm(*wide[:6])
    gen = torch.Generator().manual_seed(3)
    args, _, _ = rec_case(64, 33, gen, "cuda")
    with pytest.raises(NotImplementedError, match="f=33"):
        R.recurrence(*args, steps=3)
    with pytest.raises(NotImplementedError, match="f=33"):
        R.make_recurrence_op(3, 33)
    args, _, _ = rec_case(64, 10, gen, "cuda")
    with pytest.raises(ValueError, match="msgs is on cpu"):
        R.recurrence(args[0].cpu(), *args[1:], steps=3)
    assert set(S.launch_counts.values()) | set(R.launch_counts.values()) \
        == {0}


@pytest.mark.gpu
def test_decomposed_lipo_step_on_card():
    """Three Adam steps of lipo through the decomposed path (the SpMM
    kernels, the recurrence kernels, the edge-MLP kernels) against the
    same steps on the plain path on the card, from the same weights: the
    losses within rtol 1e-4, each launch count as designed."""
    device = _need_card()
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.kernels import recurrence as R
    from mpnn_tpu_torch.kernels import spmm as S
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train.optim import adam
    from mpnn_tpu_torch.train.trainer import (TrainConfig, batch_to_device,
                                              decomposed_hooks, train_step)
    smiles = WIDE_SMILES[:23] * 2
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(smiles,
                                                     [0.1] * len(smiles)))
    cfg = zoo.build("lipo", afm=ge.atom_width(), bfm=ge.bond_width(),
                    nafm=3, n_out=1)
    loader = G.GraphLoader(gs, 16, collate="packed")
    batches = [batch_to_device(b, device) for b, _ in zip(loader, range(3))]
    losses, counts = [], []
    for hooks in (decomposed_hooks(cfg, TrainConfig(
            fuse_step=False, fuse_recurrence=True)), None):
        S.reset_launch_counts()
        R.reset_launch_counts()
        net = network_init(cfg, torch.Generator().manual_seed(0), device)
        opt = adam(net.parameters(), 1e-2, weight_decay=1e-4)
        losses.append([float(train_step(net, opt, b, fused=False,
                                        hooks=hooks)) for b in batches])
        counts.append({**S.launch_counts, **R.launch_counts})
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    assert counts == [{"spmm_fwd": 6, "spmm_da": 3, "recurrence_fwd": 3,
                       "recurrence_bwd": 3}, dict.fromkeys(counts[0], 0)]


def sddmm_problem(rng, g, f=7, mf=None, ef=6, k=9, device="cuda", hub=0):
    """The attention SDDMM's arguments on a _problem batch (ragged graphs
    of 1 to 24 nodes, padded edges on the dummy node with vid 0): a random
    aprime (K, mf, nf) whose row 0 is not zero (as the model's A'_0 =
    pen(0)·W̃ + Bf), evocab (K, ef), wa (nf + ef, nf), ba, h (N, nf)
    random on every row (the dummy row too, so the padded edges carry
    messages), and a cotangent gout (N, mf) random on every row. With
    `hub`, that many real edges are turned to end at one real node: a
    destination of hundreds of edges, whose row crosses tiles. Returns
    (aprime, evocab, wa, ba, h, vid, src, dst, plan, gout)."""
    mf = f if mf is None else mf
    p = _problem(rng, g=g, f=f, k=k, device=device)
    n = p[3].shape[0]
    vid, src, dst, plan = p[12:16]
    if hub:
        d = dst.cpu().numpy().copy()
        real = np.nonzero(vid.cpu().numpy() > 0)[0]
        d[rng.choice(real, hub, replace=False)] = d[real[len(real) // 2]]
        dst = torch.as_tensor(d, device=device)
        plan = K.FusedEvalPlan(*(torch.as_tensor(x, device=device)
                                 for x in plan_fused_eval(
                                     d, p[5].cpu().numpy(), g)))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    return (t(rng.randn(k, mf, f) * 0.3), t(rng.randn(k, ef)),
            t(rng.randn(f + ef, f) * 0.3), t(rng.randn(f) * 0.1),
            t(rng.randn(n, f)), vid, src, dst, plan, t(rng.randn(n, mf)))


@pytest.mark.gpu
@pytest.mark.parametrize("g,f,mf,ef,k,hub,route", [
    (1024, 7, 7, 6, 9, 0, "rule"), (1024, 27, 27, 6, 64, 0, "rule"),
    (37, 7, 7, 6, 64, 0, "rule"), (37, 27, 27, 6, 9, 0, "rule"),
    (200, 10, 13, 6, 9, 0, "rule"), (2560, 7, 7, 6, 9, 0, "rule"),
    (16, 7, 7, 6, 9, 0, "rule"), (16, 10, 13, 6, 9, 0, "small tiles"),
    (16, 7, 7, 6, 9, 0, "small tiles"), (16, 27, 27, 6, 64, 0, "rule"),
    (1024, 7, 7, 6, 9, 300, "rule"), (1024, 7, 7, 6, 9, 300, "small tiles"),
    (200, 7, 7, 6, 9, 0, "small tiles"), (37, 27, 27, 6, 64, 0, "small tiles"),
    (2560, 7, 7, 6, 9, 0, "small tiles"),
    (2560, 7, 7, 6, 9, 5000, "small tiles")])
def test_cuda_sddmm_kernels_match_plain_version(g, f, mf, ef, k, hub, route):
    """sddmm_fwd and sddmm_bwd against the plain version under autograd
    at adv's bench widths (f 7, K 9) and real widths (f 27, K 64), mf !=
    nf, ragged batches, past 32k node slots (g 2560) and with a hub node
    of 300 or 5,000 real edges, on the launch rule's tiles and on the
    smallest tiles, whose long rows cross many tiles (the 5,000-edge hub
    157 of them). aprime[0], h and the cotangent are random
    at the dummy node, so the padded edges carry messages and gradients
    there; the gradients are divided by their max abs; a second run gives
    the same bits; the library's shared memory is launch_shape's."""
    _need_card()
    from chip_smoke import SDDMM_ROUTES, _sddmm_route, sddmm_value_and_grads
    from mpnn_tpu_torch.kernels import sddmm as D
    rng = np.random.RandomState(g + f + k + hub)
    c = sddmm_problem(rng, g, f=f, mf=mf, ef=ef, k=k, hub=hub)
    runs = []
    with _sddmm_route(**SDDMM_ROUTES[route]):
        for d in ("fwd", "bwd"):
            shape = D.device_shape(d, c[5].shape[0], mf, f, k, c[4].device)
            assert D.library_smem_bytes(d, shape, k, mf, f) == \
                shape.smem_bytes, shape
        for _ in range(2):
            D.reset_launch_counts()
            runs.append(sddmm_value_and_grads(D.sddmm, *c))
            torch.cuda.synchronize()
            assert D.launch_counts == {"sddmm_fwd": 1, "sddmm_bwd": 1}
    got = runs[0]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    want = sddmm_value_and_grads(lambda *x: D.sddmm_reference(*x[:8]), *c)
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    _grads_close(dict(zip(("aprime", "evocab", "wa", "ba", "h"), got[1:])),
                 dict(zip(("aprime", "evocab", "wa", "ba", "h"), want[1:])))
    assert got[0][-1].abs().max() > 0 and got[5][-1].abs().max() > 0


@pytest.mark.gpu
def test_cuda_sddmm_vocab_sizes_in_turn():
    """Both SDDMM kernels at every vocab size from 64 down to 1, then 64
    again, in one process (the narrow bucket stages aprime in K KB of
    shared memory: no launch may leave a kernel's limit below a later,
    larger K's), each within rtol/atol of the plain version; before the
    last, a K-1 backward launched from this thread while autograd launches
    the others from its own (the limit is the kernel's, not a thread's)."""
    _need_card()
    from chip_smoke import sddmm_value_and_grads
    from mpnn_tpu_torch.kernels import sddmm as D

    def case(k):
        c = list(sddmm_problem(np.random.RandomState(k), 5, f=10,
                               k=max(k, 2)))
        c[0], c[1] = c[0][:k].contiguous(), c[1][:k].contiguous()
        c[5] = c[5].clamp(max=k - 1).contiguous()
        return c
    ks = [*range(D.MAX_VOCAB, 0, -1), D.MAX_VOCAB]
    for i, k in enumerate(ks):
        c = case(k)
        if i == len(ks) - 1:
            one = case(1)
            K.launch_prepared(D.prepare_sddmm_bwd(*one[:5], one[9],
                                                  *one[5:8]))
        got = sddmm_value_and_grads(D.sddmm, *c)
        want = sddmm_value_and_grads(lambda *x: D.sddmm_reference(*x[:8]),
                                     *c)
        torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL,
                                   msg=lambda m, k=k: f"K={k}: {m}")
        _grads_close(dict(enumerate(got[1:])), dict(enumerate(want[1:])))


@pytest.mark.gpu
def test_cuda_sddmm_wrapper_raises_instead_of_falling_back():
    """Past the buckets (f 33, ef 33, K 65), on a CPU/CUDA mix, a wrong
    dtype or out-of-range ids: the wrapper raises and launches nothing."""
    _need_card()
    from mpnn_tpu_torch.kernels import sddmm as D
    c = sddmm_problem(np.random.RandomState(1), 32)
    D.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        D.sddmm(c[0].double(), *c[1:9])
    with pytest.raises(ValueError, match="aprime is on cpu"):
        D.sddmm(c[0].cpu(), *c[1:9])
    with pytest.raises(ValueError, match="vid out of range"):
        D.sddmm(*c[:5], c[5] + 9, *c[6:9])
    wide = sddmm_problem(np.random.RandomState(2), 8, f=33)
    with pytest.raises(NotImplementedError, match="f=33"):
        D.sddmm(*wide[:9])
    wide = sddmm_problem(np.random.RandomState(3), 8, ef=33)
    with pytest.raises(NotImplementedError, match="ef=33"):
        D.sddmm(*wide[:9])
    big = sddmm_problem(np.random.RandomState(4), 8, k=65)
    with pytest.raises(NotImplementedError, match="K=65"):
        D.sddmm(*big[:9])
    assert set(D.launch_counts.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("experiment,nets", [("adv_classification", 1),
                                             ("att_classification", 3)])
def test_decomposed_attention_train_verb_on_card(tmp_path, experiment,
                                                 nets):
    """`train --spmm kernel` of adv and att for one epoch of two steps
    (and one validation and one test batch) on the card: exact launch
    counts — per step and message network one sddmm_fwd, one sddmm_bwd
    and the chain's 1 + 1, one set2vec_fwd and set2vec_bwd; per eval batch
    the eval kernels and no SDDMM — and finite losses."""
    import json
    import os
    _need_card()
    from mpnn_tpu_torch.kernels import edge_mlp as M
    from mpnn_tpu_torch.kernels import fused_att as A
    from mpnn_tpu_torch.kernels import fused_att_steps as AS
    from mpnn_tpu_torch.kernels import sddmm as D
    from mpnn_tpu_torch.kernels import set2vec as S2V
    from mpnn_tpu_torch.train import cli
    smiles = (WIDE_SMILES[:10] * 4)[:40]
    csv = os.path.join(str(tmp_path), "cls.csv")
    with open(csv, "w") as fh:
        fh.write("smiles,target\n" + "".join(
            f"{s},{i % 3}\n" for i, s in enumerate(smiles)))
    log = os.path.join(str(tmp_path), "log.jsonl")
    for mod in (A, AS, D, S2V, M):
        mod.reset_launch_counts()
    cli.main(["train", "--experiment", experiment, "--data", csv,
              "--epochs", "1", "--batch-size", "16", "--log", log,
              "--spmm", "kernel"])
    with open(log) as fh:
        steps = [json.loads(x)["loss"] for x in fh if '"step"' in x]
    assert len(steps) == 2 and np.isfinite(steps).all()
    msg = "fused_att" if nets == 1 else "fused_att_steps"
    assert {**D.launch_counts, **S2V.launch_counts, **M.launch_counts,
            **A.launch_counts, **AS.launch_counts} == {
        "sddmm_fwd": 2 * nets, "sddmm_bwd": 2 * nets,
        "set2vec_fwd": 2 + 2, "set2vec_bwd": 2,
        "edge_mlp_fwd": nets * (2 + 2), "edge_mlp_bwd": nets * 2,
        "fused_att_fwd": 2 if nets == 1 else 0, "fused_att_bwd": 0,
        "fused_att_steps_fwd": 0 if nets == 1 else 2,
        "fused_att_steps_bwd": 0, **{f"{msg}_bwd": 0}}


# ---------------------------------------------------------------------------
# the split training backward (ro_bwd.cu, msg_bwd.cu, ps_walk_bwd.cu;
# kernels/split_bwd.py): each kernel against its plain version, and both
# routes' first-step gradients at b3584. Cases and batches from
# chip_smoke.py (imported inside the tests: it imports no JAX either)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("batch,f,od,steps,msg_norm,state_norm,k", [
    (1024, 10, 14, 1, "bn1d", "bn1d", None),
    (1024, 8, 16, 3, "bn1d", "bn1d", None),
    (1024, 8, 16, 3, "none", "stateless", None),
    (1024, 7, 28, 3, "bn1d", "none", None),
    (1024, 27, 108, 3, "bn1d", "bn1d", 64),
    (1024, 32, 128, 2, "none", "stateless", 64),
    (3584, 10, 14, 1, "bn1d", "bn1d", None),
    (3584, 8, 16, 3, "bn1d", "bn1d", None)])
def test_cuda_split_kernels_match_plain_version(batch, f, od, steps,
                                                msg_norm, state_norm, k):
    """ro_bwd, msg_bwd and ps_walk_bwd through their wrappers against their
    plain versions on one batch (b1024 in 16,512 node slots, b3584 in
    57,856), the wide bucket among the widths, inputs random at the padded
    node slots; each output divided by its max abs."""
    dev = _need_card()
    import chip_smoke as C
    b1024, b3584, _, _ = C._split_check_batches(dev)
    tb = b1024 if batch == 1024 else b3584
    res = C.split_kernel_case(tb, f, od, steps, msg_norm, state_norm,
                              torch.Generator().manual_seed(batch + f), dev,
                              k=k)
    assert all(ok for ok, _ in res.values()), res


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["lipo", "encoded"])
def test_split_and_whole_routes_first_step_gradients_at_b3584(model):
    """The first step's parameter gradients of each model at b3584 (57,856
    node slots) through the whole-step ops, on the whole route and on the
    split route, each within rtol 1e-4 / atol 1e-5 (scaled) of the plain
    model in float64; the split route runs its three kernels."""
    dev = _need_card()
    import dataclasses
    import chip_smoke as C
    from mpnn_tpu_torch.kernels import msg_bwd as MB
    from mpnn_tpu_torch.kernels import readout_bwd as RB
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.train import experiments
    tb = dict(C._split_check_batches(dev)[1])
    g = tb["graph_mask"].shape[0]
    dims = (tb["node_feats"].shape[1], tb["edge_feats"].shape[1],
            tb["node_nafm"].shape[1])
    if model == "lipo":
        cfg = zoo.lipo(*dims)
        tcfg = experiments.get("lipo").train
        tb["labels"] = torch.randn(g, generator=torch.Generator()
                                   .manual_seed(3)).to(dev)
    else:
        cfg = zoo.encoded(*dims, n_out=4)
        tcfg = dataclasses.replace(
            experiments.get("encoded_classification").train, loss="ce")
        tb["labels"] = torch.arange(g, device=dev) % 4
    for route in ("whole", "split"):
        RB.reset_launch_counts()
        MB.reset_launch_counts()
        with C._route(route):
            got, _, exact = C._fused_first_grads(cfg, tcfg, tb, dev)
        launched = RB.launch_counts["ro_bwd"] + MB.launch_counts["msg_bwd"]
        assert launched == (2 if route == "split" else 0)
        margin, where, worst = C.fused_grad_distance(cfg, got, exact)
        assert margin <= 1, (route, where, worst)


@pytest.mark.gpu
def test_cuda_split_wrappers_raise_instead_of_falling_back():
    """A wrong device, dtype or width raises; nothing falls back to the
    plain version or the whole route."""
    dev = _need_card()
    from mpnn_tpu_torch.kernels import msg_bwd as MB
    from mpnn_tpu_torch.kernels import readout_bwd as RB
    RB.reset_launch_counts()
    MB.reset_launch_counts()
    rng = np.random.RandomState(12)
    c, _ = _ps_problem(rng, 64)
    n, f = c["h0"].shape
    g = c["labels"].shape[0]
    x = torch.randn(n, f, device=dev)
    st = torch.stack([x.mean(0), x.var(0)])
    ro = {s: {k: v.detach() for k, v in c["ro"][s].items()} for s in "ij"}
    od = ro["i"]["b"].shape[0]
    gout = torch.randn(g, od, device=dev)
    ro_args = (x, st, torch.ones(f, device=dev), torch.zeros(f, device=dev),
               c["h0"].detach(), c["mask"], c["node_graph"], ro,
               c["labels"], c["gmask"], gout, gout, torch.ones(1, device=dev))
    with pytest.raises(TypeError, match="float32"):
        RB.ro_bwd(x.double(), *ro_args[1:], state_norm="bn1d")
    with pytest.raises(ValueError, match="is on cpu"):
        RB.ro_bwd(*ro_args[:4], ro_args[4], ro_args[5].cpu(),
                  *ro_args[6:], state_norm="bn1d")
    dm = torch.randn(3, n, f, device=dev)
    msg_args = (c["amat"].detach(), c["a0"].detach(), c["h0"].detach(),
                c["mask"], c["node_graph"], c["vid"], c["src"], c["dst"], dm,
                c["plan"])
    with pytest.raises(ValueError, match="dmsgs has shape"):
        MB.msg_bwd(*msg_args[:8], dm[:2], c["plan"])
    wide = torch.zeros(3, 8, 33, 33, device=dev)
    with pytest.raises(NotImplementedError, match="f=33"):
        MB.msg_bwd(wide, torch.zeros(3, 33, 33, device=dev),
                   torch.zeros(n, 33, device=dev), *msg_args[3:8],
                   torch.zeros(3, n, 33, device=dev), c["plan"])
    assert RB.launch_counts["ro_bwd"] == MB.launch_counts["msg_bwd"] == 0
