"""Windowed pose-graph optimization (bundle-adjustment layer).

No reference equivalent: supereight tracks frame-to-model only and drifts
on long trajectories (SURVEY.md section 5, long-context analogue). This
layer keeps a keyframe graph with SE(3) relative-pose constraints and
solves the Gauss-Newton normal equations over a sliding window:

  minimize  sum_e  || log( T_meas_e^-1 · T_i^-1 · T_j ) ||^2_{W_e}

Device shape: per-edge residuals and Jacobians are vmapped (parallel over
edges — sharded over devices when the window grows), assembled into the
6Nx6N normal matrix by scatter-add (the collective-reduction point in the
multi-host setting), and solved by dense Cholesky — windows are small
(N <= 64 -> H is <= 384x384), so the solve is negligible next to
residual construction.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from supereight_tpu.core import se3

# Pose products in true f32: a GPU may run a default-precision f32
# matmul in TF32 (~3 decimal digits), far too coarse for poses.
_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HIGHEST)


def rot_to_quat(R):
    """Rotation matrix -> quaternion (w, x, y, z), branchless Shepperd.

    All four candidate quaternions are computed and the best-conditioned
    one selected with where-masks, so autodiff flows through a smooth
    branch (the selected denominator is bounded below by 1)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    d0 = 1.0 + r00 + r11 + r22       # 4 w^2
    d1 = 1.0 + r00 - r11 - r22       # 4 x^2
    d2 = 1.0 - r00 + r11 - r22       # 4 y^2
    d3 = 1.0 - r00 - r11 + r22       # 4 z^2
    ds = jnp.stack([d0, d1, d2, d3], axis=-1)
    best = jnp.argmax(ds, axis=-1)

    def cand(d, a, b, c, order):
        s = jnp.sqrt(jnp.maximum(d, 1e-12))
        half = 0.5 * s
        inv = 0.5 / s
        vals = [half, a * inv, b * inv, c * inv]
        out = [None] * 4
        for slot, v in zip(order, vals):
            out[slot] = v
        return jnp.stack(out, axis=-1)

    q0 = cand(d0, r21 - r12, r02 - r20, r10 - r01, (0, 1, 2, 3))
    q1 = cand(d1, r21 - r12, r01 + r10, r02 + r20, (1, 0, 2, 3))
    q2 = cand(d2, r02 - r20, r01 + r10, r12 + r21, (2, 0, 1, 3))
    q3 = cand(d3, r10 - r01, r02 + r20, r12 + r21, (3, 0, 1, 2))
    q = jnp.where((best == 0)[..., None], q0,
                  jnp.where((best == 1)[..., None], q1,
                            jnp.where((best == 2)[..., None], q2, q3)))
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def so3_log(R):
    """Rotation matrix -> axis-angle [..., 3], differentiable at identity.

    Quaternion route with a Taylor branch for small rotations (polynomial
    in the vector part, so jacfwd at a zero residual is exact)."""
    q = rot_to_quat(R)
    qw, qv = q[..., 0], q[..., 1:]
    nv_sq = jnp.sum(qv * qv, axis=-1)
    small = nv_sq < 1e-10
    nv = jnp.sqrt(jnp.where(small, 1.0, nv_sq))
    big_scale = 2.0 * jnp.arctan2(nv, qw) / nv
    taylor = 2.0 / jnp.maximum(qw, 1e-6) \
        * (1.0 - nv_sq / (3.0 * jnp.maximum(qw, 1e-6) ** 2))
    return qv * jnp.where(small, taylor, big_scale)[..., None]


def se3_log(T):
    """SE(3) matrix -> twist [..., 6] (translation, rotation) — inverse of
    se3.exp."""
    w = so3_log(T[..., :3, :3])
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq)
    # Taylor window sized for f32: below theta ~ 1e-3 the closed forms
    # lose all precision (1 - cos(1e-4) underflows to 0 in f32, making
    # b = 0 -> coef = inf -> NaN translations) while the series is
    # already exact to f32 there.
    small = theta_sq < 1e-6
    th = jnp.where(small, 1.0, theta)
    W = se3.hat(w)
    W2 = _mm(W, W)
    half = 0.5 * th
    sin_half = jnp.sin(half)
    # b = (1 - cos th)/th^2 = 2 sin^2(th/2)/th^2 — the half-angle form
    # keeps full precision at small angles
    b = jnp.where(small, 0.5 - theta_sq / 24.0,
                  2.0 * sin_half * sin_half / (th * th))
    eye = jnp.broadcast_to(jnp.eye(3), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2, standard closed form
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(th) / th)
    coef = jnp.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                     (1.0 - a / (2.0 * b)) / (th * th))
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = jnp.einsum("...ij,...j->...i", Vinv, T[..., :3, 3],
                   precision=_HIGHEST)
    return jnp.concatenate([v, w], axis=-1)


class PoseGraph(NamedTuple):
    """Edge list over a pose window (fixed-capacity, mask-extended)."""
    i: jnp.ndarray        # int32[E] source node
    j: jnp.ndarray        # int32[E] target node
    t_meas: jnp.ndarray   # f32[E, 4, 4] measured relative pose T_i^-1 T_j
    weight: jnp.ndarray   # f32[E] scalar information (isotropic)
    valid: jnp.ndarray    # bool[E]


def edge_residual(t_i, t_j, t_meas):
    """r = log(T_meas^-1 T_i^-1 T_j), [6]."""
    rel = _mm(se3.inverse(t_i), t_j)
    return se3_log(_mm(se3.inverse(t_meas), rel))


def _residual_local(xi, xj, t_i, t_j, t_meas):
    """Residual as a function of local tangent perturbations (for AD)."""
    ti = _mm(se3.exp(xi), t_i)
    tj = _mm(se3.exp(xj), t_j)
    return edge_residual(ti, tj, t_meas)


@functools.partial(jax.jit, static_argnames=("num_nodes", "iters"))
def optimize(poses, graph: PoseGraph, num_nodes: int, iters: int = 10,
             damping: float = 1e-6, fixed=None):
    """Gauss-Newton over the window; node 0 is the gauge (held fixed).

    poses: f32[N, 4, 4] camera-to-world. Returns optimized poses.

    ``fixed`` (optional bool[N]): additional nodes held EXACTLY fixed —
    frozen loop-closure anchors kept alive past the sliding window
    (posegraph.keyframes pins them) serve as gauge for the long loop.
    Fixed nodes are eliminated by masking: their rows/columns of H are
    replaced by identity and their gradient zeroed, so the solve leaves
    them untouched without hurting conditioning.
    """
    zeros6 = jnp.zeros(6)
    if fixed is None:
        fixed = jnp.zeros((num_nodes,), bool)
    fixed = fixed.at[0].set(True)  # node 0 is always gauge
    free6 = jnp.repeat(~fixed, 6).astype(jnp.float32)

    def gn_step(poses, _):
        def per_edge(i, j, t_meas, w, valid):
            ti, tj = poses[i], poses[j]
            r = edge_residual(ti, tj, t_meas)
            ji = jax.jacfwd(_residual_local, argnums=0)(
                zeros6, zeros6, ti, tj, t_meas)
            jj = jax.jacfwd(_residual_local, argnums=1)(
                zeros6, zeros6, ti, tj, t_meas)
            scale = jnp.where(valid, w, 0.0)
            return r * scale, ji * scale, jj * scale

        r, ji, jj = jax.vmap(per_edge)(graph.i, graph.j, graph.t_meas,
                                       graph.weight, graph.valid)

        n6 = 6 * num_nodes
        H = jnp.zeros((n6, n6))
        b = jnp.zeros(n6)

        def blocks(idx_a, idx_b, ja, jb):
            return jnp.einsum("eki,ekj->eij", ja, jb,
                              precision=jax.lax.Precision.HIGHEST)

        # scatter-add the four 6x6 blocks of every edge
        def add_block(H, rows, cols, vals):
            r0 = rows[:, None, None] * 6 + jnp.arange(6)[None, :, None]
            c0 = cols[:, None, None] * 6 + jnp.arange(6)[None, None, :]
            return H.at[jnp.broadcast_to(r0, vals.shape),
                        jnp.broadcast_to(c0, vals.shape)].add(vals)

        H = add_block(H, graph.i, graph.i, blocks(0, 0, ji, ji))
        H = add_block(H, graph.i, graph.j, blocks(0, 1, ji, jj))
        H = add_block(H, graph.j, graph.i, blocks(1, 0, jj, ji))
        H = add_block(H, graph.j, graph.j, blocks(1, 1, jj, jj))

        def add_b(b, nodes, jac):
            rows = nodes[:, None] * 6 + jnp.arange(6)[None, :]
            vals = jnp.einsum("eki,ek->ei", jac, r,
                              precision=jax.lax.Precision.HIGHEST)
            return b.at[rows].add(vals)

        b = add_b(b, graph.i, ji)
        b = add_b(b, graph.j, jj)

        # gauge fixing: fixed nodes (node 0 + frozen anchors) held
        # EXACTLY fixed by masking their rows/cols out of H and placing
        # identity on their diagonal — equivalent to the reduced solve
        # over free nodes, static-shaped, and well-conditioned (a stiff
        # prior instead puts ~1e8 on the diagonal, pushing cond(H) past
        # f32 Cholesky range — the solve then emits NaNs once the
        # residuals converge)
        H = H * free6[:, None] * free6[None, :] \
            + jnp.diag(1.0 - free6) + jnp.eye(n6) * damping
        b = b * free6
        dx = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(H, lower=True), b)
        dx = (dx * free6).reshape(num_nodes, 6)
        new_poses = jax.vmap(lambda d, T: _mm(se3.exp(d), T))(dx, poses)
        return new_poses, jnp.linalg.norm(dx)

    poses, _ = jax.lax.scan(gn_step, poses, None, length=iters)
    return poses
