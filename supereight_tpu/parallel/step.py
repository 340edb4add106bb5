"""Fused whole-frame step: one jitted program per frame.

The stage-level functions in ops/ mirror the reference's per-kernel
structure; this module composes them into a single XLA program
(preprocess -> track -> allocate -> integrate -> raycast) so a frame is
one dispatch — the unit that gets sharded across a device mesh in
parallel/sharding.py. The reference has no equivalent (its stages are
synchronous CPU calls); this is the accelerator's execution shape.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from supereight_tpu import constants as C
from supereight_tpu.core import se3
from supereight_tpu.core.map import MapState
from supereight_tpu.ops import allocation, integration, raycast, tracking
from supereight_tpu.pipeline import _preprocess_and_pyramid


class FrameState(NamedTuple):
    map: MapState
    pose: jnp.ndarray          # camera-to-world, [4, 4]
    raycast_pose: jnp.ndarray  # pose of the last raycast
    vertex: jnp.ndarray        # [H, W, 3] reference maps for ICP
    normal: jnp.ndarray
    valid: jnp.ndarray


def init_frame_state(geom, field, frame_size, init_pose):
    from supereight_tpu.core.map import make_map
    import numpy as np
    w, h = frame_size
    # distinct device buffers per leaf (np -> device transfer): identical
    # jnp.zeros constants may share one buffer, which frame_step's state
    # donation would otherwise try to donate twice
    p = jnp.asarray(np.asarray(init_pose, np.float32))
    return FrameState(
        map=make_map(geom, field),
        pose=p,
        raycast_pose=jnp.asarray(np.asarray(init_pose, np.float32)),
        vertex=jnp.asarray(np.zeros((h, w, 3), np.float32)),
        normal=jnp.asarray(np.zeros((h, w, 3), np.float32)),
        valid=jnp.asarray(np.zeros((h, w), bool)),
    )


def integration_budget(geom, n_blocks: int) -> int:
    """Static integration worklist budget from a LIVE block count: the
    next power of two covering it (one recompile per doubling), clamped
    to capacity. Matches pipeline._budget_bucket; keeping the fused step
    at a fixed 8192 silently skipped fusion for blocks beyond the budget
    on big maps (ADVICE r2) — the reference updates every active block
    (projective_functor.hpp:139-156)."""
    n = max(int(n_blocks), 1)
    bucket = 1024
    while bucket < n:
        bucket *= 2
    return min(bucket, geom.capacity)


@functools.partial(
    jax.jit,
    static_argnames=("geom", "field", "frame_size", "iterations",
                     "mu", "icp_threshold", "neg_y", "filter_input",
                     "use_gt_pose", "integration_rate", "tracking_rate",
                     "budget", "depth_interp", "alloc_budget",
                     "noise_weighted", "min_ref_weight",
                     "fuse_filtered"),
    # the 150+ MB map pool updates in place instead of copy-on-write
    # (callers consume the state exactly once per frame)
    donate_argnames=("state",))
def frame_step(geom, field, state: FrameState, depth_m, k, frame,
               gt_pose=None, *,
               frame_size, iterations,
               mu, icp_threshold,
               neg_y, filter_input, use_gt_pose=False,
               integration_rate=2, tracking_rate=1,
               budget=8192, depth_interp=False, alloc_budget=None,
               noise_weighted=False, min_ref_weight=0,
               fuse_filtered=False):
    """Run one full frame; returns (new_state, aux dict of device arrays).

    ``frame`` is a traced int32 scalar so one compiled program serves the
    whole sequence; the reference's rate gates (DenseSLAMSystem.cpp:146,
    209, 195) become lax.cond branches.

    ``budget`` is the static integration worklist size — derive it from
    the live block count with :func:`integration_budget`. The aux dict
    carries drop-accounting counters (``blocks_truncated``,
    ``alloc_overflow``, ``ray_overflow``): all zero in a well-sized run;
    nonzero values mean budgets need raising for this scene.
    """
    depths, verts, norms, valids = _preprocess_and_pyramid(
        depth_m, k, len(iterations), neg_y, filter_input)

    # ---- tracking (or ground-truth bypass) ---------------------------
    if use_gt_pose:
        pose = jnp.asarray(gt_pose, jnp.float32)
        tracked = jnp.bool_(True)
        reduction = jnp.zeros((32,), jnp.float32)
        result = jnp.zeros(depth_m.shape, jnp.int32)
    else:
        do_track = (frame % tracking_rate) == 0
        pose_t, tracked_t, reduction, result = tracking.track(
            state.pose, state.raycast_pose, k, verts, norms, valids,
            state.vertex, state.normal, state.valid,
            iterations, icp_threshold)
        pose = jnp.where(do_track, pose_t, state.pose)
        tracked = jnp.where(do_track, tracked_t, False)

    # ---- integration --------------------------------------------------
    # no-cond gating: the reference's tracked/rate gate
    # (DenseSLAMSystem.cpp:206-212) is applied by MASKING the map writes
    # (``when``) instead of lax.cond — a cond branch cannot alias the
    # donated pool buffers, so XLA inserted a full pool copy-on-write
    # on every integrated frame.
    do_integrate = (tracked | (frame <= 3)) \
        & (((frame % integration_rate) == 0) | (frame <= 3))

    if field.multiscale_alloc:
        m2, astats = allocation.allocate_ofusion(
            geom, state.map, depths[0], pose, k, mu, with_stats=True,
            when=do_integrate, budget=alloc_budget)
    else:
        m2, astats = allocation.allocate_tsdf(
            geom, state.map, depths[0], pose, k, mu, with_stats=True,
            when=do_integrate, budget=alloc_budget)
    # fuse_filtered (noise-grade option): integrate the FILTERED depth
    # instead of the raw one. The reference fuses raw (float_depth_,
    # DenseSLAMSystem.cpp:218-253; its bilateral only feeds tracking),
    # but with z^2 range noise the projective-TSDF update is BIASED at
    # grazing incidence: the write gate diff > -mu drops the negative
    # noise tail while min(1, diff/mu) keeps the positive one, so when
    # sigma_along_ray ~ mu (sigma stretched 1/sin(incidence) on grazing
    # surfaces) the fused crossing recedes from the camera each frame —
    # measured as a runaway vertical slide (0.45 m) on the loop scene's
    # grazing table top. Filtering cuts sigma ~2.4x (median-of-9), which
    # collapses the bias cubically.
    fuse_depth = depths[0] if fuse_filtered else depth_m
    new_map, istats = integration.integrate(
        geom, m2, field, fuse_depth, pose, k, mu,
        (1.0 / 30.0) * frame.astype(jnp.float32), frame_size,
        budget=budget, depth_interp=depth_interp, with_stats=True,
        when=do_integrate, noise_weighted=noise_weighted)
    alloc_overflow = astats["alloc_overflow"]
    blocks_truncated = istats["blocks_truncated"]

    # ---- raycast ------------------------------------------------------
    # no-cond here either: running the raycast on the 3 bootstrap
    # frames too (outputs masked below) avoids a lax.cond that would
    # block XLA's buffer aliasing of the donated state on every frame.
    view = jnp.matmul(pose, se3.inverse_camera_matrix(k),
                      precision=jax.lax.Precision.HIGHEST)
    # the raycast pose IS this frame's pose, so the depth frame
    # primes the march (raycast.prime_from_depth)
    prime = raycast.prime_from_depth(depth_m, k)
    r_vertex, r_normal, r_valid, rstats = raycast.raycast(
        geom, new_map, field, view, mu, frame_size,
        prime_t=prime, with_stats=True, pool_bucket=budget)

    if min_ref_weight > 0 and field.name == "tsdf":
        # (TSDF only: channel 1 is the fusion WEIGHT there; for OFusion
        # it is the last-update timestamp, which is not a maturity
        # measure — the flag is a no-op for occupancy)
        # map-maturity gate (noise-grade option, no reference
        # counterpart): drop reference pixels whose hit voxel has fused
        # fewer than min_ref_weight observations. Under z^2 sensor
        # noise, freshly-created map regions carry the noise AND pose
        # error of the frames that built them; tracking against them is
        # a positive-feedback loop (measured: deeper ICP convergence
        # made the noisy-loop drift WORSE, 0.36 -> 0.58 ATE). Mature
        # regions average the noise away (weight grows 1/frame,
        # sdf_update running mean), so gating the ICP at weight >= W
        # keeps the pose anchored to converged geometry.
        from supereight_tpu.core.map import get_voxel_channel_c
        iv = geom.inv_voxel_size
        hvx = jnp.floor(r_vertex[..., 0] * iv).astype(jnp.int32)
        hvy = jnp.floor(r_vertex[..., 1] * iv).astype(jnp.int32)
        hvz = jnp.floor(r_vertex[..., 2] * iv).astype(jnp.int32)
        w_ref = get_voxel_channel_c(geom, new_map, field, hvx, hvy, hvz,
                                    channel=1, fill=0.0)
        r_valid = r_valid & (w_ref >= min_ref_weight)

    do_raycast = frame > 2
    vertex = jnp.where(do_raycast, r_vertex, state.vertex)
    normal = jnp.where(do_raycast, r_normal, state.normal)
    valid = jnp.where(do_raycast, r_valid, state.valid)
    rstats = {"ray_overflow": jnp.where(do_raycast,
                                        rstats["ray_overflow"], 0)}
    raycast_pose = jnp.where(do_raycast, pose, state.raycast_pose)

    new_state = FrameState(map=new_map, pose=pose,
                           raycast_pose=raycast_pose,
                           vertex=vertex, normal=normal, valid=valid)
    aux = {"tracked": tracked, "integrated": do_integrate,
           "reduction": reduction, "track_result": result,
           "n_blocks": new_map.n_blocks,
           "alloc_overflow": alloc_overflow,
           "blocks_truncated": blocks_truncated,
           "patch_skipped": istats["patch_skipped"],
           "mip_skipped": istats["mip_skipped"],
           "ray_overflow": rstats["ray_overflow"],
           # blocks allocated this frame past the strips pool bucket are
           # read as UNKNOWN by this frame's raycast (build_nav guard) —
           # counted so an undersized bucket is observable (ADVICE r3)
           "pool_bucket_overflow": jnp.maximum(new_map.n_blocks - budget, 0)}
    return new_state, aux
