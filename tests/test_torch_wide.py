"""Every ported kernel family's plain op at the widths real datasets
produce, against the JAX package's Pallas kernels in interpret mode on the
CPU: the shared family (rows 1-3: eval, training forward and backward) at
f 24 and 32, od up to 64; the per-step family (rows 13, 14a) at f 24-32
with graph_norm's od = 4·afm at 96 and 128; the attention kernels (row 15)
at f 32; the T-step attention kernels (row 16) at f 24; set2vec (row 12)
at w 64. These are the widths the CUDA kernels' wide buckets take
(kernels/*.py::BUCKETS); tests/test_torch_gpu.py and chip_smoke.py hold
the kernels against these plain versions on the card.

Graphs are small (a few molecules' worth of nodes) and depth is cut
(T <= 3, set2vec 3 steps). Tolerances are each family's own CPU test's:
forward rtol 2e-4 / atol 1e-5; gradient leaves divided by their max abs,
rtol 2e-4 / atol 1e-5 (rows 1-3, 13-15, 12) or rtol 5e-4 / atol 3e-5
(row 16, tests/test_torch_att_steps_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpnn_tpu.kernels.set2vec import make_set2vec_op
from mpnn_tpu_torch.kernels import fused_att as A
from mpnn_tpu_torch.kernels import fused_att_steps as AS
from mpnn_tpu_torch.kernels import fused_psteps as P
from mpnn_tpu_torch.kernels import fused_step as K
from mpnn_tpu_torch.kernels import set2vec as S
from test_fused_step import build_problem
from test_torch_att_kernels import (assert_leaves_close, att_problem,
                                    jax_att, jax_s2v, s2v_problem,
                                    torch_att_args, torch_s2v)
from test_torch_att_steps_kernels import jax_steps, steps_problem, torch_steps
from test_torch_fused_eval import _jax_out, _states, _torch_args
from test_torch_fused_step import _jax_step, _torch_step
from test_torch_psteps_kernels import (assert_grads_close, eval_call,
                                       jax_eval, jax_step, psteps_problem,
                                       step_grads, torch_inputs)

RTOL, ATOL = 2e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 3e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert np.abs(want).max() > 1e-2          # not a trivial comparison
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("f,od", [(24, 48), (32, 64)])
def test_shared_family_at_wide_widths(f, od):
    """Rows 1-3 (lipo's od = 2·afm): the eval op against the Pallas eval
    kernel, and the training op's loss, out, statistics and every gradient
    against the Pallas training kernels, both norms on."""
    rng = np.random.RandomState(f)
    args, plan, dims = build_problem(rng, n=96, g=8, f=f, od=od, steps=2)
    assert K.width_bucket("", K.BUCKETS, f=f, od=od) == "f32"
    ma_state, bn_state = _states(rng, f)
    want = _jax_out(args, plan, dims, ma_state, bn_state, "bn1d", "bn1d")
    got = K.fused_eval(*_torch_args(args, dims, ma_state, bn_state),
                       steps=2, msg_norm="bn1d", state_norm="bn1d")
    _close(got.numpy(), want)
    cw = rng.randn(dims["g"], od).astype(np.float32)
    want = _jax_step(args, plan, dims, cw, "bn1d", "bn1d")
    got = _torch_step(args, dims, cw, "bn1d", "bn1d")
    _close(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for a, b in zip([got[2], *got[3]], [want[2], *want[3]]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
    for name, w in want[4].items():
        if name == "mbias":                   # zero in theory under bn1d
            assert np.abs(got[4][name] - w).max() <= ATOL * np.abs(
                want[4]["a0"]).max()
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[4][name] / scale, w / scale,
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("f,od,msg_norm,state_norm",
                         [(24, 96, "none", "stateless"),
                          (32, 128, "bn1d", "bn1d")])
def test_per_step_family_at_wide_widths(f, od, msg_norm, state_norm):
    """Rows 13 and 14a at graph_norm's od = 4·afm (96, 128): serving, and
    training's loss, out, every slot's statistics and every gradient."""
    args, plan, dims, cw = psteps_problem(f, n=96, g=8, f=f, od=od)
    assert K.width_bucket("", P.BUCKETS, f=f, od=od, steps=3) == "f32"
    kw = dict(steps=dims["steps"], msg_norm=msg_norm, state_norm=state_norm)
    c, _ = torch_inputs(args, dims)
    _close(eval_call(P.fused_psteps_eval, c, **kw).numpy(),
           jax_eval(args, plan, dims, msg_norm, state_norm))
    want = jax_step(args, plan, dims, cw, msg_norm, state_norm)
    c, leaves = torch_inputs(args, dims, grad=True)
    loss, out, ma, st, grads = step_grads(P.fused_psteps, c, leaves, cw, **kw)
    np.testing.assert_allclose(loss.detach().numpy(), want[0], rtol=RTOL,
                               atol=ATOL)
    _close(out.detach().numpy(), want[1])
    for a, b in zip([*ma, *st], [*want[2], *want[3]]):
        np.testing.assert_allclose(a[0].numpy(), b[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a[1].numpy(), b[1], rtol=RTOL, atol=ATOL)
    assert_grads_close({k: v.numpy() for k, v in grads.items()}, want[4],
                       msg_norm)


@pytest.mark.parametrize("with_corr", [True, False])
def test_attention_kernels_at_f32(with_corr):
    """Row 15 at f 32: h and the gradient in every leaf."""
    p, plan, dims, cw = att_problem(5, n=96, g=8, f=32)
    assert K.width_bucket("", A.BUCKETS, f=32, K=dims["k"]) == "f32"
    want_h, want_g = jax_att(p, plan, dims, cw, with_corr)
    args, leaves = torch_att_args(p, dims)
    h = A.fused_att(*args, with_corr=with_corr)
    grads = torch.autograd.grad((h * torch.tensor(cw)).sum(),
                                list(leaves.values()), allow_unused=True)
    _close(h.detach().numpy(), want_h)
    assert_leaves_close(
        {k: (np.zeros(v.shape, np.float32) if gr is None else gr.numpy())
         for (k, v), gr in zip(leaves.items(), grads)}, want_g)


@pytest.mark.parametrize("per_step", [True, False])
def test_t_step_attention_kernels_at_f24(per_step):
    """Row 16 at f 24, the att model's mode (the stateless norm, 'adj'),
    per-step and shared tables: h and the gradient in every leaf."""
    tm = 3 if per_step else 1
    p, plan, dims, cw = steps_problem(6, tm, n=96, g=8, f=24)
    assert K.width_bucket("", AS.BUCKETS, f=24, K=dims["k"],
                          steps=3) == "f32"
    kw = dict(state_norm="stateless", with_corr=False)
    want_h, want_g = jax_steps(p, plan, dims, cw, per_step=per_step, **kw)
    got_h, got_g = torch_steps(p, dims, cw, **kw)
    _close(got_h, want_h)
    assert_leaves_close(got_g, want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("batch_softmax", [True, False])
def test_set2vec_at_w64(batch_softmax):
    """Row 12 at w 64 (f 32): m (G, 128) and the gradient in every
    readout leaf and x, 3 steps."""
    rp, x, mask, ng, gnp, plan, cw = s2v_problem(7, n=96, g=8, nf=32)
    n, w = x.shape
    assert w == 64 and K.width_bucket("", S.BUCKETS, w=w) == "w64"
    op = make_set2vec_op(w, n, gnp.shape[0] - 1, time_steps=3,
                         node_window=plan.node_window, interpret=True,
                         batch_softmax=batch_softmax)
    ns = jnp.asarray(plan.node_start)
    want = jax_s2v(lambda r, xx: op(r, xx, jnp.asarray(mask),
                                    jnp.asarray(ng), ns), rp, x, cw)
    got = torch_s2v(rp, x, mask, ng, gnp, cw, time_steps=3,
                    batch_softmax=batch_softmax)
    _close(got[0], want[0])
    assert_leaves_close(got[1], want[1])


def test_buckets_and_the_widths_past_them():
    """Each family picks the narrowest bucket that holds a batch; past the
    widest it raises NotImplementedError naming the widths."""
    pick = K.width_bucket
    assert pick("", K.BUCKETS, f=10, od=14) == ""
    assert pick("", K.BUCKETS, f=19, od=32) == "f32"
    # the basic shell's od = 4·afm: afm 7 in the f 16 / od 64 bucket, afm
    # 17-32 in the od-128 one
    assert pick("", K.BUCKETS, f=7, od=28) == "o64"
    assert pick("", K.BUCKETS, f=20, od=65) == "o128"
    assert pick("", K.BUCKETS, f=27, od=108) == "o128"
    assert pick("", P.BUCKETS, f=8, od=32, steps=8) == ""
    assert pick("", P.BUCKETS, f=16, od=64, steps=3) == "f32"
    assert pick("", A.BUCKETS, f=16, K=64) == ""
    assert pick("", A.BUCKETS, f=17, K=64) == "f32"
    assert pick("", S.BUCKETS, w=32) == "" and pick("", S.BUCKETS,
                                                    w=34) == "w64"
    for buckets, widths, match in [
            (K.BUCKETS, dict(f=33, od=14), "fused: f=33, od=14; the "
             "kernels are compiled for widths up to f=16, od=16 or f=16, "
             "od=64 or f=32, od=64 or f=32, od=128"),
            (K.BUCKETS, dict(f=20, od=129), "f=20, od=129"),
            (P.BUCKETS, dict(f=33, od=128, steps=3), "f=33, od=128"),
            (P.BUCKETS, dict(f=24, od=96, steps=7), "steps=7"),
            (A.BUCKETS, dict(f=33, K=8), "f=33"),
            (A.BUCKETS, dict(f=8, K=65), "K=65"),
            (AS.BUCKETS, dict(f=8, K=8, steps=9), "steps=9"),
            (S.BUCKETS, dict(w=66), "w=66")]:
        with pytest.raises(NotImplementedError, match=match):
            pick("fused", buckets, **widths)
