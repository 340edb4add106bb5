"""Projective-ICP camera tracking.

Behavioral reference: se_denseslam/src/tracking.cpp. Per-pixel
point-to-plane residuals against the previous frame's raycast
(trackKernel, 226-302), a 32-float reduction (reduceKernel, 66-224), a
6x6 normal-equation solve + SE3 update (updatePoseKernel, 304-318) and
divergence rollback (checkPoseKernel, 320-336).

On the device the residual pass is one fused elementwise+gather program
per iteration, the reduction is a single jnp.sum (psum across devices
in the sharded pipeline), and the tiny 6x6 solve runs per-step. The
coarse-to-fine iteration loop is a lax.while_loop with an early-exit
convergence flag, so one compiled loop body per pyramid level.
"""

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from supereight_tpu.constants import (DIST_THRESHOLD, INVALID,
                                      NORMAL_THRESHOLD, TRACK_BAD_NORMAL,
                                      TRACK_NO_INPUT, TRACK_NO_REF_NORMAL,
                                      TRACK_OK, TRACK_OUT_OF_FRAME,
                                      TRACK_TOO_FAR, TRACK_THRESHOLD)
from supereight_tpu.core import se3
from supereight_tpu.utils.loops import bounded_steps

# Upper-triangle index pairs of the 6x6 JtJ, row-major — the layout
# makeJTJ (tracking.cpp:42-55) expects in the 21-vector.
_TRIU = [(r, c) for r in range(6) for c in range(r, 6)]


def pack_reference(ref_vertex, ref_normal, ref_valid):
    """Pack the previous raycast's maps into [H*W, 8] rows for the
    per-iteration reference gather (vertex, normal, valid, pad)."""
    h, w = ref_vertex.shape[:2]
    return jnp.concatenate(
        [ref_vertex, ref_normal,
         ref_valid[..., None].astype(jnp.float32),
         jnp.zeros((h, w, 1), jnp.float32)], axis=-1).reshape(h * w, 8)


def track_residuals(in_vertex, in_normal, in_valid, ref_vertex, ref_normal,
                    ref_valid, t_track, view,
                    dist_threshold=DIST_THRESHOLD,
                    normal_threshold=NORMAL_THRESHOLD,
                    ref_packed=None):
    """Per-pixel point-to-plane residual + jacobian (trackKernel, 226-302).

    in_*: current-frame maps at one pyramid level [h, w, ...] (camera frame).
    ref_*: previous raycast maps at full resolution [H, W, ...] (world frame).
    t_track: current camera-to-world pose estimate.
    view: K @ raycast_pose^-1 (projects world points into the ref image).
    Returns (result i32[h,w], error f32[h,w], J f32[h,w,6]).
    """
    ref_h, ref_w = ref_vertex.shape[:2]

    # component-wise throughout: [h, w] arrays, no [..., 3] stacking in
    # the iterated path (tiny minor dims, see se3.transform_c)
    ivx, ivy, ivz = (in_vertex[..., 0], in_vertex[..., 1], in_vertex[..., 2])
    pvx, pvy, pvz = se3.transform_c(t_track, ivx, ivy, ivz)   # world frame
    ppx, ppy, ppz = se3.transform_c(view, pvx, pvy, pvz)
    safe_z = jnp.where(ppz == 0, 1.0, ppz)
    proj_px = ppx / safe_z + 0.5
    proj_py = ppy / safe_z + 0.5
    in_frame = ((proj_px >= 0) & (proj_px <= ref_w - 1)
                & (proj_py >= 0) & (proj_py <= ref_h - 1))

    rx = jnp.clip(proj_px.astype(jnp.int32), 0, ref_w - 1)
    ry = jnp.clip(proj_py.astype(jnp.int32), 0, ref_h - 1)
    flat = (ry * ref_w + rx).reshape(-1)
    if ref_packed is None:
        ref_packed = pack_reference(ref_vertex, ref_normal, ref_valid)
    # one 32-byte-row gather fetches vertex+normal+valid together
    # (gather cost was per ROW on the earlier accelerator, so 8
    # channels rode free; unmeasured on the H100)
    ref = ref_packed[flat].reshape(rx.shape + (8,))
    rvx, rvy, rvz = ref[..., 0], ref[..., 1], ref[..., 2]
    rnx, rny, rnz = ref[..., 3], ref[..., 4], ref[..., 5]
    ref_ok = ref[..., 6] > 0

    dx_, dy_, dz_ = rvx - pvx, rvy - pvy, rvz - pvz
    inx, iny, inz = (in_normal[..., 0], in_normal[..., 1], in_normal[..., 2])
    pnx, pny, pnz = se3.rotate_c(t_track, inx, iny, inz)
    dist = jnp.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    ndot = pnx * rnx + pny * rny + pnz * rnz

    # rejection cascade, in reference order (-1 .. -5)
    result = jnp.full(in_vertex.shape[:2], TRACK_OK, jnp.int32)
    result = jnp.where(ndot < normal_threshold, TRACK_BAD_NORMAL, result)
    result = jnp.where(dist > dist_threshold, TRACK_TOO_FAR, result)
    result = jnp.where(~ref_ok, TRACK_NO_REF_NORMAL, result)
    result = jnp.where(~in_frame, TRACK_OUT_OF_FRAME, result)
    result = jnp.where(~in_valid, TRACK_NO_INPUT, result)

    error = rnx * dx_ + rny * dy_ + rnz * dz_
    # j_rot = projected_vertex x reference_normal
    jrx = pvy * rnz - pvz * rny
    jry = pvz * rnx - pvx * rnz
    jrz = pvx * rny - pvy * rnx
    ok = result == TRACK_OK
    okf = ok.astype(jnp.float32)
    error = error * okf
    jac = (rnx * okf, rny * okf, rnz * okf,
           jrx * okf, jry * okf, jrz * okf)
    return result, error, jac


_TRIU_R = np.asarray([r for r, _ in _TRIU])
_TRIU_C = np.asarray([c for _, c in _TRIU])


def reduce_tracking(result, error, jac):
    """Masked reduction to the reference's 32-float layout (reduceKernel).

    [0]=sum err^2, [1:7]=J^T e, [7:28]=upper-tri J^T J, [28]=inliers,
    [29]=#too-far, [30]=#bad-normal, [31]=#other-rejects.

    The reference's strided 8x32 accumulator tree (tracking.cpp:66-224)
    is a Gram matrix in disguise: with z = [e | J] per pixel (rejected
    pixels zeroed by track_residuals), the 28 products z_i * z_j hold
    sum(e^2), J^T e and J^T J. Computed as 28 sibling reductions over
    the seven [h, w] component arrays — XLA fuses them into one pass
    (and they become a single psum across devices in the sharded
    pipeline). ``jac`` is a 6-tuple of [h, w] components (or a stacked
    [h, w, 6] array from external callers).
    """
    if not isinstance(jac, (tuple, list)):
        jac = tuple(jac[..., i] for i in range(6))
    z = (error,) + tuple(jac)
    terms = [jnp.sum(z[0] * z[0])]
    terms += [jnp.sum(z[0] * z[1 + i]) for i in range(6)]
    terms += [jnp.sum(z[1 + r] * z[1 + c]) for r, c in _TRIU]
    terms += [
        jnp.sum((result == TRACK_OK).astype(jnp.float32)),
        jnp.sum((result == TRACK_TOO_FAR).astype(jnp.float32)),
        jnp.sum((result == TRACK_BAD_NORMAL).astype(jnp.float32)),
        jnp.sum(((result < 1) & (result > TRACK_TOO_FAR))
                .astype(jnp.float32)),
    ]
    return jnp.stack(terms)


# symmetric [6, 6] of positions into the 21-vector (row-major upper tri)
_SYM_IDX = np.asarray(
    [[{**{(r, c): i for i, (r, c) in enumerate(_TRIU)},
       **{(c, r): i for i, (r, c) in enumerate(_TRIU)}}[(a, b)]
      for b in range(6)] for a in range(6)], jnp.int32)


def make_jtj(v21):
    """21-vector -> symmetric 6x6 (makeJTJ, tracking.cpp:42-55)."""
    return v21[_SYM_IDX]


def _cholesky_solve6(A, b):
    """Unrolled 6x6 Cholesky solve.

    jax.scipy's generic blocked cho_factor lowers to dozens of tiny
    sequential kernels, each a launch per GN step. Fully unrolled over
    scalars it fuses into one kernel. A
    non-SPD system yields sqrt(<0) = nan, caught by the caller's
    finite check (the reference's LLT-failure fallback).
    """
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for kk in range(j):
                s = s - L[i][kk] * L[j][kk]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for kk in range(i):
            s = s - L[i][kk] * y[kk]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for kk in range(i + 1, 6):
            s = s - L[kk][i] * x[kk]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def solve_normal_equations(reduction):
    """x = (J^T J)^{-1} J^T e from the 32-vector (solve, tracking.cpp:57-64).

    A failed (non-finite) solve returns zeros, matching the reference's
    LLT-failure fallback.
    """
    b = reduction[1:7]
    C = make_jtj(reduction[7:28])
    x = _cholesky_solve6(C, b)
    finite = jnp.all(jnp.isfinite(x))
    return jnp.where(finite, x, 0.0)


def update_pose(pose, reduction, icp_threshold):
    """Apply one GN step (updatePoseKernel, 304-318).

    Returns (new_pose, converged).
    """
    x = solve_normal_equations(reduction)
    delta = se3.exp(x)
    new_pose = jnp.matmul(delta, pose, precision=jax.lax.Precision.HIGHEST)
    return new_pose, jnp.linalg.norm(x) < icp_threshold


def check_pose(pose, old_pose, reduction, image_size,
               track_threshold=TRACK_THRESHOLD):
    """Accept or roll back the tracked pose (checkPoseKernel, 320-336).

    Returns (pose, tracked: bool).
    """
    n_inliers = reduction[28]
    rms = jnp.sqrt(reduction[0] / jnp.where(n_inliers == 0, 1.0, n_inliers))
    total = image_size[0] * image_size[1]
    bad = (rms > 2e-2) | (n_inliers / total < track_threshold) \
        | (n_inliers == 0)
    return jnp.where(bad, old_pose, pose), ~bad


@functools.partial(jax.jit, static_argnames=("iterations", "axis_name",
                                              "n_shards"))
def track(pose, raycast_pose, k_full, pyr_vertex, pyr_normal, pyr_valid,
          ref_vertex, ref_normal, ref_valid,
          iterations: Sequence[int], icp_threshold,
          axis_name=None, n_shards: int = 1,
          dist_threshold=DIST_THRESHOLD):
    """Full coarse-to-fine ICP (DenseSLAMSystem::tracking, 143-189).

    pyr_*: tuples of per-level maps, finest first. Returns
    (new_pose, tracked, final_reduction, result_map_finest).

    DISTRIBUTED mode (``axis_name`` set, inside shard_map over
    ``n_shards`` devices): each device computes residuals for its COLUMN
    slice of every pyramid level (columns because the bench widths stay
    divisible through the pyramid) against the full (gathered) reference
    maps, and the 32-float normal-equation reduction becomes a psum —
    the distributed ICP reduction of BASELINE.md's north star. Every
    device then applies the identical pose update. The finest result map
    is returned as the LOCAL column slice (callers all_gather if they
    need the full map).
    """
    view = jnp.matmul(se3.camera_matrix(k_full), se3.inverse(raycast_pose),
                      precision=jax.lax.Precision.HIGHEST)
    old_pose = pose
    reduction = jnp.zeros((32,))
    if axis_name is not None:
        shard_idx = jax.lax.axis_index(axis_name)

    # The GN iterations run as a bounded rolled loop with a `done` flag
    # freezing converged state (utils/loops.bounded_steps). Freezing on
    # `done` and exiting once it is set reproduces the reference's
    # per-level early break (tracking.cpp:183-185) exactly: once
    # ||x|| < threshold, pose/reduction/result stop changing. In the
    # sharded step `done` comes from the psum'd reduction, so every
    # device leaves the loop at the same iteration.
    ref_packed = pack_reference(ref_vertex, ref_normal, ref_valid)
    result_fine = None
    for level in range(len(iterations) - 1, -1, -1):
        iv, inorm, ival = pyr_vertex[level], pyr_normal[level], pyr_valid[level]
        if axis_name is not None:
            w_loc = iv.shape[1] // n_shards
            start = shard_idx * w_loc
            iv = jax.lax.dynamic_slice_in_dim(iv, start, w_loc, 1)
            inorm = jax.lax.dynamic_slice_in_dim(inorm, start, w_loc, 1)
            ival = jax.lax.dynamic_slice_in_dim(ival, start, w_loc, 1)

        def body(c, iv=iv, inorm=inorm, ival=ival):
            pose, reduction, result, done = c
            res, err, jac = track_residuals(iv, inorm, ival, ref_vertex,
                                            ref_normal, ref_valid, pose,
                                            view, ref_packed=ref_packed,
                                            dist_threshold=dist_threshold)
            red = reduce_tracking(res, err, jac)
            if axis_name is not None:
                red = jax.lax.psum(red, axis_name)
            new_pose, converged = update_pose(pose, red, icp_threshold)
            pose = jnp.where(done, pose, new_pose)
            reduction = jnp.where(done, reduction, red)
            result = jnp.where(done, result, res)
            return (pose, reduction, result, done | converged)

        result0 = jnp.zeros(iv.shape[:2], jnp.int32)
        pose, reduction, result, _ = bounded_steps(
            body, (pose, reduction, result0, jnp.bool_(False)),
            iterations[level], lambda c: ~c[3])

        if level == 0:
            result_fine = result

    image_size = ref_vertex.shape[:2]
    pose, tracked = check_pose(pose, old_pose, reduction, image_size)
    return pose, tracked, reduction, result_fine
