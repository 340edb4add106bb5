"""Bounded loops for gather-bearing marching bodies.

The hot iterative kernels (raycast march cascade, ICP Gauss-Newton) run
a fixed step budget with per-lane masks: ``body`` freezes lanes that are
done, so extra steps are no-ops. :func:`bounded_steps` runs that budget
as one rolled ``lax.while_loop`` with a global early exit (one compiled
loop body, no work once every lane is done), or unrolled where the
caller measured that to pay (the raycast march on the GPU).
"""

import jax
from jax import lax


def bounded_steps(body, carry, steps: int, still_active, unroll=False):
    """Apply ``body`` up to ``steps`` times.

    body: carry -> carry, must be a fixed-point once ``still_active``
        is False (all lanes masked done).
    still_active: carry -> bool scalar, True while any lane needs work.
    unroll: trace ``steps`` copies of ``body`` instead: no early exit
        and no per-step loop predicate, for a program that grows with
        ``steps``. Same result, since done lanes are fixed points.
    """
    if unroll:
        for _ in range(steps):
            carry = body(carry)
        return carry

    def cond(c):
        i, cc = c
        return (i < steps) & still_active(cc)

    def b(c):
        i, cc = c
        return (i + 1, body(cc))

    return lax.while_loop(cond, b, (0, carry))[1]


def lane_select(row, lane):
    """Select ``row[..., lane]`` per element with a log2 select tree.

    ``row`` is [..., W] (W a power of two), ``lane`` int32 [...] in
    [0, W). The tree is log2(W) vectorized selects on halving widths;
    it compiles far faster than a one-hot multiply-reduce.
    """
    w = row.shape[-1]
    assert w & (w - 1) == 0
    while w > 1:
        h = w // 2
        hi = (lane & h) != 0
        row = jax.numpy.where(hi[..., None], row[..., h:w], row[..., :h])
        w = h
    return row[..., 0]
