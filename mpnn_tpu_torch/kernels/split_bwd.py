"""Where a training step's backward splits: the route rule of the two
whole-step training ops (kernels/fused_step.py::fused_step and
kernels/fused_psteps.py::fused_psteps).

Each op has two backward routes, which compute the same gradients:

  * whole — one kernel (csrc/fused_step_bwd.cu, csrc/fused_psteps_bwd.cu);
  * split — the readout + loss VJP (csrc/ro_bwd.cu), the reverse walk
    through the recurrence (csrc/recurrence_bwd.cu for the shared family,
    csrc/ps_walk_bwd.cu for the per-step one), then the message VJP
    (csrc/msg_bwd.cu).

The node count past which the JAX package splits the backward is a copy
of its rule (mpnn_tpu/kernels/recurrence.py::_vmem_bwd_fits and
pick_stream_blk; mpnn_tpu/kernels/fused_psteps.py::PS_MONO_BWD_NPAD_CAP):
the port splits at the same place, so both packages run the same
decomposition on the same batch. The rule is a pure function of the
family, the step count, the width, the node slots and the norms; the
ops decide it in the forward, which then keeps what the split backward
reads.
"""

from __future__ import annotations

# the shared family's one-kernel backward holds (T + 1 + 26) panels of
# round_up(f, 16) × npad float32 values within 96 MiB
LIVE_PANELS = 26
WHOLE_BWD_BYTES = 96 * 2 ** 20
# the per-step family's one-kernel backward takes up to this many padded
# node slots (round_up(n, 128))
PS_WHOLE_NPAD_CAP = 28672
# the node-block cap of pick_stream_blk
STREAM_BLK_CAP = 16384

ROUTES = ("auto", "whole", "split")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_stream_blk(n: int, cap: int = STREAM_BLK_CAP) -> int:
    """The 128-aligned node block of the fewest blocks of at most `cap`
    that cover n: the padding unit of the shared family's rule."""
    npad = _round_up(n, 128)
    nb = -(-npad // cap)
    return _round_up(-(-npad // nb), 128)


def shared_splits(steps: int, f: int, n: int) -> bool:
    """True past the shared family's one-kernel backward: (T + 27) ·
    round_up(f, 16) · npad · 4 bytes over 96 MiB, npad = n rounded up to
    pick_stream_blk(n)."""
    npad = _round_up(n, pick_stream_blk(n))
    need = (steps + 1 + LIVE_PANELS) * _round_up(f, 16) * npad * 4
    return need > WHOLE_BWD_BYTES


def psteps_splits(n: int) -> bool:
    """True past the per-step family's one-kernel backward."""
    return _round_up(n, 128) > PS_WHOLE_NPAD_CAP


def route(family: str, *, steps: int, f: int, n: int, msg_norm: str,
          state_norm: str, bwd: str = "auto") -> str:
    """'whole' or 'split' for one batch of `family` ('shared': lipo's
    fused_step; 'psteps': graph_norm's and encoded's fused_psteps). `bwd`
    forces a route ('whole', 'split') or leaves it to the rule ('auto').
    The shared family splits only with bn1d/bn1d norms: its split reverse
    walk is the bn1d recurrence (the JAX package caps the other pairs'
    batches before they would split), so forcing it otherwise raises."""
    if bwd not in ROUTES:
        raise ValueError(f"bwd={bwd!r}; expected one of {ROUTES}")
    if family == "shared":
        bn = msg_norm == "bn1d" and state_norm == "bn1d"
        if bwd == "split" and not bn:
            raise NotImplementedError(
                "the streaming merged reverse walk is bn1d-only; non-bn1d "
                "norm modes require the one-kernel backward (eligibility "
                "caps the node count)")
        if bwd == "auto":
            return "split" if bn and shared_splits(steps, f, n) else "whole"
        return bwd
    if family == "psteps":
        if bwd == "auto":
            return "split" if psteps_splits(n) else "whole"
        return bwd
    raise ValueError(f"family={family!r}; expected 'shared' or 'psteps'")
