"""The dense SLAM pipeline orchestrator.

Behavioral reference: DenseSLAMSystem
(se_denseslam/include/se/DenseSLAMSystem.h:58-411 and
src/DenseSLAMSystem.cpp). The class is a thin stateful shell over jitted
functional stages; all per-frame state (map, poses, pyramid maps, raycast
maps) lives in JAX arrays so a full frame can run on-device end to end.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from supereight_tpu import constants as C
from supereight_tpu.config import Configuration, default_camera
from supereight_tpu.core import se3
from supereight_tpu.core.map import MapGeometry, make_map
from supereight_tpu.fields import get_field
from supereight_tpu.ops import allocation, integration, preprocess, raycast, \
    tracking


@functools.partial(jax.jit, static_argnames=("levels", "neg_y", "filter_input"))
def _preprocess_and_pyramid(depth_m, k, levels: int, neg_y: bool,
                            filter_input):
    """Filter + build the depth/vertex/normal pyramid
    (ref DenseSLAMSystem::preprocessing + tracking's pyramid prep,
    DenseSLAMSystem.cpp:128-164).

    ``filter_input``: False = none, True/"bilateral" = the reference's
    5x5 bilateral (-F), "median" = 3x3 median (the noise-grade option,
    preprocess.median_filter3)."""
    if filter_input == "median":
        d0 = preprocess.median_filter3(depth_m)
    elif filter_input == "median2":
        # iterated 3x3 median: ~2x more sigma reduction than one pass
        # while still edge-preserving (for heavy z^2 range noise)
        d0 = preprocess.median_filter3(preprocess.median_filter3(depth_m))
    elif filter_input:
        d0 = preprocess.bilateral_filter(depth_m)
    else:
        d0 = depth_m
    depths = [d0]
    for _ in range(1, levels):
        depths.append(preprocess.half_sample_robust(depths[-1],
                                                    C.E_DELTA * 3.0))
    verts, norms, valids = [], [], []
    for i, d in enumerate(depths):
        inv_k = se3.inverse_camera_matrix(k / (1 << i))
        v = preprocess.depth2vertex(d, inv_k)
        n, ok = preprocess.vertex2normal(v, neg_y)
        verts.append(v)
        norms.append(n)
        valids.append(ok)
    return tuple(depths), tuple(verts), tuple(norms), tuple(valids)


class DenseSLAMSystem:
    """Stateful pipeline facade (ref DenseSLAMSystem.h:58-411)."""

    def __init__(self, input_size: Tuple[int, int],
                 config: Configuration,
                 init_pose: Optional[np.ndarray] = None):
        self.config = config
        w, h = input_size
        r = config.compute_size_ratio
        self.computation_size = (w // r, h // r)

        cam = config.camera or default_camera(w, h)
        self.k = jnp.asarray(cam, jnp.float32) / r

        self.field = get_field(config.field)
        self.geom = MapGeometry(size=config.volume_resolution,
                                dim=config.volume_size,
                                capacity=config.resolve_capacity())
        self.map = make_map(self.geom, self.field)

        if init_pose is None:
            t = np.asarray(config.initial_pos_factor) * config.volume_size
            init_pose = np.eye(4, dtype=np.float32)
            init_pose[:3, 3] = t
        self.pose = jnp.asarray(init_pose, jnp.float32)
        self.init_pose = self.pose
        self.old_pose = self.pose
        self.raycast_pose = self.pose

        cw, ch = self.computation_size
        self.float_depth = jnp.zeros((ch, cw), jnp.float32)
        self.vertex = jnp.zeros((ch, cw, 3), jnp.float32)
        self.normal = jnp.zeros((ch, cw, 3), jnp.float32)
        self.valid = jnp.zeros((ch, cw), bool)
        self.pyr = None
        self.reduction = jnp.zeros((32,), jnp.float32)
        self.track_result = jnp.zeros((ch, cw), jnp.int32)

        self._iterations = tuple(config.pyramid)
        self._neg_y = float(self.k[1]) < 0
        # self-sizing per-frame allocation bucket (see integration())
        from supereight_tpu.core.map import ALLOC_BUDGET
        self._alloc_budget = ALLOC_BUDGET
        # drop-accounting counters from the latest frame (device scalars;
        # all zero in a well-sized run — see frame_step docstring)
        self.stats = {}
        # optional windowed pose-graph BA layer (enable_keyframes)
        self.keyframes = None
        self.trajectory_correction = np.eye(4, dtype=np.float32)

    # ------------------------------------------------------------------
    # pipeline stages (ref DenseSLAMSystem.cpp:128-268)
    # ------------------------------------------------------------------
    def preprocessing(self, depth, is_mm: bool = True) -> bool:
        """depth: [H, W] u16 mm (is_mm) or f32 meters at input size."""
        if is_mm:
            depth_m = preprocess.mm2meters(
                jnp.asarray(depth), (self.computation_size[1],
                                     self.computation_size[0]))
        else:
            d = jnp.asarray(depth, jnp.float32)
            r = self.config.compute_size_ratio
            depth_m = d[::r, ::r]
        self.float_depth = depth_m
        self.pyr = _preprocess_and_pyramid(
            depth_m, self.k, len(self._iterations), self._neg_y,
            self.config.filter_input)
        return True

    def tracking(self, frame: int) -> bool:
        if frame % self.config.tracking_rate != 0:
            return False
        self.old_pose = self.pose
        _, verts, norms, valids = self.pyr
        pose, tracked, reduction, result = tracking.track(
            self.pose, self.raycast_pose, self.k, verts, norms, valids,
            self.vertex, self.normal, self.valid,
            self._iterations, self.config.icp_threshold)
        self.pose = pose
        self.reduction = reduction
        self.track_result = result
        return bool(tracked)

    def _budget_bucket(self) -> int:
        """Static integration budget from the live block count.

        jit shapes are static, so the worklist budget is rounded up to a
        power of two covering all allocated blocks (one recompile per
        doubling — a handful over a run) instead of paying the worst-case
        budget every frame. Integration cost is dominated by the
        per-voxel depth strip fetch ([budget, 512] rows), so this bound
        is the stage's cost knob."""
        n = max(int(self.map.n_blocks), 1, self.config.preset_budget)
        bucket = 1024
        while bucket < n:
            bucket *= 2
        return min(bucket, self.geom.capacity)

    def integration(self, frame: int) -> bool:
        if not (frame % self.config.integration_rate == 0 or frame <= 3):
            return False
        depths = self.pyr[0]
        if self.field.multiscale_alloc:
            self.map, astats = allocation.allocate_ofusion(
                self.geom, self.map, depths[0], self.pose, self.k,
                self.config.mu, with_stats=True,
                budget=self._alloc_budget)
        else:
            self.map, astats = allocation.allocate_tsdf(
                self.geom, self.map, depths[0], self.pose, self.k,
                self.config.mu, with_stats=True,
                budget=self._alloc_budget)
        # self-sizing allocation bucket (the reference allocates ALL
        # candidate octants, octree.hpp:792-817): an overflowing frame
        # doubles the bucket for subsequent frames — one recompile per
        # doubling; the overflowed cells are re-touched next frame.
        # Polled every 8th frame: the scalar fetch is a device-to-host
        # sync, and the bucket reaction can lag a few frames
        # (overflowed cells stay observed and re-touch).
        if frame % 8 == 0 and int(astats["alloc_overflow"]) > 0:
            b = self.geom.blocks_per_side
            self._alloc_budget = min(2 * self._alloc_budget, b ** 3)
        timestamp = (1.0 / 30.0) * frame
        # fuse_filtered: see parallel/step.py — noise-grade deviation
        # (the reference fuses the raw float_depth_)
        fuse_depth = (self.pyr[0][0] if self.config.fuse_filtered
                      else self.float_depth)
        self.map, istats = integration.integrate(
            self.geom, self.map, self.field, fuse_depth, self.pose,
            self.k, self.config.mu, timestamp, self.computation_size,
            self._budget_bucket(), depth_interp=self.config.depth_interp,
            with_stats=True,
            noise_weighted=self.config.noise_weighted)
        self.stats = dict(self.stats, alloc_overflow=astats["alloc_overflow"],
                          blocks_truncated=istats["blocks_truncated"],
                          patch_skipped=istats.get("patch_skipped", 0),
                          mip_skipped=istats.get("mip_skipped", 0))
        return True

    def raycasting(self, frame: int) -> bool:
        if frame <= 2:
            return False
        self.raycast_pose = self.pose
        view = jnp.matmul(self.raycast_pose,
                          se3.inverse_camera_matrix(self.k),
                          precision=jax.lax.Precision.HIGHEST)
        prime = raycast.prime_from_depth(self.float_depth, self.k)
        self.vertex, self.normal, self.valid, rstats = raycast.raycast(
            self.geom, self.map, self.field, view, self.config.mu,
            self.computation_size, prime_t=prime, with_stats=True,
            pool_bucket=self._budget_bucket())
        if self.config.min_ref_weight > 0 and self.field.name == "tsdf":
            # map-maturity ICP gate (see parallel/step.py min_ref_weight)
            from supereight_tpu.core.map import get_voxel_channel_c
            iv = self.geom.inv_voxel_size
            hv = jnp.floor(self.vertex * iv).astype(jnp.int32)
            w_ref = get_voxel_channel_c(
                self.geom, self.map, self.field, hv[..., 0], hv[..., 1],
                hv[..., 2], channel=1, fill=0.0)
            self.valid = self.valid & (w_ref >= self.config.min_ref_weight)
        self.stats = dict(self.stats, ray_overflow=rstats["ray_overflow"])
        return True

    def process_frame(self, depth, frame: int, is_mm: bool = True,
                      gt_pose: Optional[np.ndarray] = None) -> dict:
        """One full frame (ref benchmark.cpp:115-177 / mainQt.cpp:201-313).

        gt_pose: ground-truth camera-to-world pose; when given, tracking is
        bypassed (ref mainQt.cpp:257-265 setPose path).
        """
        self.preprocessing(depth, is_mm=is_mm)
        if gt_pose is not None:
            self.pose = jnp.asarray(gt_pose, jnp.float32)
            tracked = True
        else:
            tracked = self.tracking(frame)
        integrated = False
        if tracked or frame <= 3:
            integrated = self.integration(frame)
        raycasted = self.raycasting(frame)
        if self.keyframes is not None and tracked and gt_pose is None \
                and frame > 2:
            self._keyframe_step(frame)
        return {"tracked": tracked, "integrated": integrated,
                "raycasted": raycasted, **self.stats}

    # ------------------------------------------------------------------
    # windowed pose-graph BA layer (no reference equivalent; the
    # long-trajectory capability named in BASELINE.md — keyframe graph +
    # loop-closure re-localization + Gauss-Newton window optimization)
    # ------------------------------------------------------------------
    def enable_keyframes(self, every: int = 10, window: int = 32,
                         ba_every: int = 4, loop_closure: bool = True,
                         reanchor: bool = False,
                         closure_dist: float = 1.0):
        """Turn on keyframe recording + windowed BA.

        ``every``: keyframe cadence in frames. ``ba_every``: optimize the
        window every N keyframes (and immediately on a loop closure).
        ``loop_closure``: re-localize against the stored raycast maps of
        a revisited keyframe (ICP, same tracker) and add the resulting
        constraint. ``reanchor``: also left-multiply the LIVE pose by the
        latest correction (off by default: frame-to-model tracking pulls
        the pose back toward the fused map, so the default is to publish
        corrections via ``trajectory_correction`` for the output
        trajectory, leaving live tracking undisturbed).
        """
        from supereight_tpu.posegraph.keyframes import KeyframeManager
        self.keyframes = KeyframeManager(window=window, keyframe_every=every)
        self._ba_every = ba_every
        self._loop_closure = loop_closure
        self._reanchor = reanchor
        # revisit radius (m): must exceed keyframe spacing along the
        # trajectory or a loop that closes BETWEEN keyframes never
        # finds a candidate (the r5 no-closure bug on the 250-frame
        # loop: nearest keyframe 0.89 m away with the old 0.5 default)
        self._closure_dist = closure_dist
        self._pending_ba = False

    def _keyframe_step(self, frame: int):
        km = self.keyframes
        added = km.maybe_add(frame, self.pose, self.reduction,
                             ref_maps=(self.vertex, self.normal, self.valid))
        if not added:
            return
        idx = len(km.poses) - 1
        if self._loop_closure:
            cand = km.nearest_revisit(self.pose,
                                      max_dist=self._closure_dist)
            if cand is not None and km.ref_maps[cand] is not None:
                rv, rn, rok = (jnp.asarray(m) for m in km.ref_maps[cand])
                _, verts, norms, valids = self.pyr
                # the loop-closure tracker runs with a RELAXED
                # residual gate (3x the reference's 0.1 m tracking
                # threshold): a closure exists precisely because the
                # live pose has drifted decimeters from the revisited
                # keyframe, and the default gate rejects every residual
                # of that size before ICP can pull it in
                pose_lc, ok_lc, red, _ = tracking.track(
                    self.pose, jnp.asarray(km.poses[cand]), self.k,
                    verts, norms, valids, rv, rn, rok,
                    self._iterations, self.config.icp_threshold,
                    dist_threshold=3.0 * C.DIST_THRESHOLD)
                import sys
                print(f"# loop-closure try kf{cand}<-kf{idx} "
                      f"ok={bool(ok_lc)} "
                      f"inl={int(np.asarray(red)[28])} "
                      f"|dp|={np.linalg.norm(np.asarray(pose_lc)[:3, 3] - np.asarray(self.pose)[:3, 3]):.3f}",
                      file=sys.stderr)
                if bool(ok_lc):
                    t_meas = (np.linalg.inv(km.poses[cand])
                              @ np.asarray(pose_lc))
                    w = max(float(np.asarray(red)[28]), 1.0) ** 0.5
                    km.add_loop_closure(cand, idx, t_meas, w)
                    self._pending_ba = True
        if self._pending_ba or (len(km.poses) % self._ba_every == 0
                                and len(km.edges) > 0):
            km.optimize()
            corr = km.correction_for_latest()
            self.trajectory_correction = corr
            if self._reanchor:
                self.pose = jnp.matmul(
                    jnp.asarray(corr, jnp.float32), self.pose,
                    precision=jax.lax.Precision.HIGHEST)
            self._pending_ba = False

    # ------------------------------------------------------------------
    # rendering + export (ref DenseSLAMSystem.cpp:270-322)
    # ------------------------------------------------------------------
    def render_depth(self):
        from supereight_tpu.ops import rendering
        return np.asarray(rendering.render_depth(self.float_depth))

    def render_track(self):
        from supereight_tpu.ops import rendering
        return np.asarray(rendering.render_track(self.track_result))

    def render_volume(self, view_pose=None):
        from supereight_tpu.ops import rendering
        reuse = view_pose is None
        pose = self.raycast_pose if reuse else jnp.asarray(view_pose)
        return np.asarray(rendering.render_volume(
            self.geom, self.map, self.field, pose, self.k, self.config.mu,
            self.computation_size, vertex=self.vertex, normal=self.normal,
            valid=self.valid, reuse_maps=reuse))

    def dump_mesh(self, filename: str):
        """Marching-cubes surface export (ref dump_mesh,
        DenseSLAMSystem.cpp:302-322)."""
        from supereight_tpu.io import meshing
        tris = meshing.marching_cubes(self.geom, self.map)
        if filename.endswith(".obj"):
            meshing.write_obj(filename, tris)
        else:
            meshing.write_vtk(filename, tris)
        return tris

    def save_map(self, filename: str):
        from supereight_tpu.io.serialise import save_map
        save_map(filename, self.geom, self.map, self.field)

    def save_checkpoint(self, filename: str):
        """Full run checkpoint: map + pose state + raycast maps.

        Extends the reference's map-only snapshots (octree.hpp:897-950 —
        pose/trajectory state is not checkpointed there, SURVEY.md §5)
        so a crashed/preempted run resumes mid-trajectory.
        """
        from supereight_tpu.io.serialise import save_map
        save_map(filename, self.geom, self.map, self.field)
        np.savez_compressed(
            filename + ".run",
            pose=np.asarray(self.pose),
            raycast_pose=np.asarray(self.raycast_pose),
            vertex=np.asarray(self.vertex),
            normal=np.asarray(self.normal),
            valid=np.asarray(self.valid),
        )

    def load_checkpoint(self, filename: str):
        from supereight_tpu.io.serialise import load_map
        geom, state, field = load_map(filename)
        assert geom == self.geom and field.name == self.field.name, \
            "checkpoint geometry/field mismatch"
        self.map = state
        z = np.load(filename + ".run.npz")
        self.pose = jnp.asarray(z["pose"])
        self.raycast_pose = jnp.asarray(z["raycast_pose"])
        self.vertex = jnp.asarray(z["vertex"])
        self.normal = jnp.asarray(z["normal"])
        self.valid = jnp.asarray(z["valid"])

    # ------------------------------------------------------------------
    # getters (ref DenseSLAMSystem.h getters)
    # ------------------------------------------------------------------
    def get_position(self):
        return np.asarray(self.pose[:3, 3])

    def get_pose(self):
        return np.asarray(self.pose)

    def set_pose(self, pose):
        self.pose = jnp.asarray(pose, jnp.float32)

    def get_depth(self):
        return np.asarray(self.float_depth)

    def block_count(self) -> int:
        return int(self.map.n_blocks)
