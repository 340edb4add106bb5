"""Morton-range sharded SLAM step: explicit halo exchange over a mesh.

No reference equivalent (supereight is single-process OpenMP,
SURVEY.md §2.4); this implements the BASELINE.md north star — shard the
voxel-block pool by MORTON KEY RANGE across devices, distribute the ICP
reduction, and raycast through an explicitly exchanged frustum halo.

Design (shard_map over a 1-D mesh of D devices):

* **Ownership.** Block cell c belongs to device ``morton(c) * D / B^3``:
  contiguous morton ranges are spatially compact (Z-curve locality), so
  fusion writes and most of a frame's active blocks are device-local.
  Each device holds an ordinary local :class:`MapState` over its range
  (capacity = global capacity / D), bump-allocated locally.

* **Images** are sharded by COLUMNS (widths stay divisible by 8 devices
  through the pyramid at the bench sizes). Per frame, one all-gather
  rebuilds the full depth and the previous raycast's reference maps
  (~2 MB at 320x240 — image work is cheap elementwise math, so pyramids are computed
  replicated; the map, which is what outgrows a chip, never is).

* **Tracking** computes residuals on each device's column slice against
  the gathered reference maps; the 32-float normal-equation reduction is
  a psum (ops/tracking.track axis_name mode) — the distributed ICP
  reduction of the north star.

* **Allocation** marches the touched-block bands on each device's OWN
  image columns (allocation.py x_offset), unions the per-device grids
  with a psum-OR (~0.26 MB — exact match of the full-image mask, r5),
  masks the union to the device's morton range, and allocates into the
  local pool. A psum-OR of local occupancy keeps the replicated mip
  existence masks globally consistent.

* **Integration** is fully local: each device fuses its own blocks from
  the gathered depth. Zero map communication.

* **Raycast halo exchange.** Each device compacts its (margin-padded)
  frustum-intersecting allocated blocks into (cell id, march-encoded
  brick) pairs; one all-gather builds the frame's global halo table,
  from which every device constructs the nav grid + strip pair
  (ops/raycast format) and marches the rays of its own image columns.
  Halo traffic = blocks-in-frustum x 2-4 KB (strips_dtype), counted in aux.
  ``frustum_halo=False`` exchanges ALL allocated blocks instead (exact;
  used by the equivalence tests).

The frustum margin: the in-frustum test projects the block CENTER and
accepts a border of ``margin`` x image size plus any block within 0.5 m
of the camera, covering the reference predicate's corner-vs-extent slack
(algorithms::in_frustum projects one corner, filter.hpp:37-49); rays
only traverse the view cone, so blocks outside the padded frustum cannot
affect them.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supereight_tpu.constants import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu.core import morton, se3
from supereight_tpu.core import map as m
from supereight_tpu.core.map import MapGeometry, MapState
from supereight_tpu.ops import allocation, integration, raycast, tracking
from supereight_tpu.pipeline import _preprocess_and_pyramid

AXIS = "shards"


class DistState(NamedTuple):
    """Sharded frame state (global views; shard_map slices per device)."""
    map: MapState            # data/coords sharded over slots; slot/n per-dev
    pose: jnp.ndarray        # replicated [4,4]
    raycast_pose: jnp.ndarray
    vertex: jnp.ndarray      # [H, W, 3] column-sharded
    normal: jnp.ndarray
    valid: jnp.ndarray


def owner_grid(geom: MapGeometry, n_shards: int,
               tile: int = 64) -> np.ndarray:
    """[B,B,B] i32 device owner of every block cell: BLOCK-CYCLIC over
    the morton curve (north star: shard the pool by morton key).

    ``tile`` consecutive morton cells (64 = a 4x4x4-block super-brick)
    go to one device, tiles round-robin across devices. Pure contiguous
    ranges (tile = B^3 / n_shards) maximize locality but collapse under
    non-uniform occupancy (a centered room scene put ~15x more blocks on
    half the devices); 64-cell tiles keep fusion/halo locality at
    super-brick granularity while balancing statistically. ``tile=1``
    degenerates to spatial round-robin."""
    b = geom.blocks_per_side
    g = np.arange(b, dtype=np.int32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    codes = np.asarray(morton.encode_v(jnp.asarray(coords)))
    return ((codes // tile) % n_shards).astype(np.int32).reshape(b, b, b)


def make_mesh(n_devices=None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def init_dist_state(mesh: Mesh, geom_local: MapGeometry, field, frame_size,
                    init_pose) -> DistState:
    """Empty sharded state. ``geom_local`` is the PER-DEVICE geometry
    (capacity = global capacity / n_devices).

    Built INSIDE a jit with out_shardings, so it also works in the
    multi-process runtime (jax.distributed) where a host cannot
    device_put onto non-addressable devices.
    """
    d = mesh.devices.size
    w, h = frame_size
    cap = geom_local.capacity
    b = geom_local.blocks_per_side
    init_x, init_y = field.init
    nl = geom_local.num_levels
    pose0 = np.asarray(init_pose, np.float32)

    def build():
        return DistState(
            map=MapState(
                data_x=jnp.full((d * cap, BLOCK_VOXELS), init_x,
                                jnp.float32),
                data_y=jnp.full((d * cap, BLOCK_VOXELS), init_y,
                                jnp.float32),
                block_coord=jnp.zeros((d * cap, 3), jnp.int32),
                active=jnp.zeros((d * cap,), bool),
                slot=jnp.full((d, b, b, b), -1, jnp.int32),
                n_blocks=jnp.zeros((d,), jnp.int32),
                mip_x=tuple(jnp.full(((b >> l),) * 3, init_x, jnp.float32)
                            for l in range(nl)),
                mip_y=tuple(jnp.full(((b >> l),) * 3, init_y, jnp.float32)
                            for l in range(nl)),
                mip_alloc=tuple(jnp.zeros(((b >> l),) * 3, bool)
                                for l in range(nl)),
            ),
            pose=jnp.asarray(pose0),
            raycast_pose=jnp.asarray(pose0),
            vertex=jnp.zeros((h, w, 3), jnp.float32),
            normal=jnp.zeros((h, w, 3), jnp.float32),
            valid=jnp.zeros((h, w), bool),
        )

    proto = jax.eval_shape(build)
    sh = dist_state_shardings(mesh, proto)
    return jax.jit(build, out_shardings=sh)()


def dist_state_shardings(mesh: Mesh, state: DistState) -> DistState:
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    rep = s()
    nl = len(state.map.mip_x)
    return DistState(
        map=MapState(
            data_x=s(AXIS, None), data_y=s(AXIS, None),
            block_coord=s(AXIS, None), active=s(AXIS),
            slot=s(AXIS, None, None, None), n_blocks=s(AXIS),
            mip_x=tuple(rep for _ in range(nl)),
            mip_y=tuple(rep for _ in range(nl)),
            mip_alloc=tuple(rep for _ in range(nl)),
        ),
        pose=rep, raycast_pose=rep,
        vertex=s(None, AXIS, None), normal=s(None, AXIS, None),
        valid=s(None, AXIS),
    )


def _dist_specs(nl):
    """PartitionSpecs matching dist_state_shardings (for shard_map)."""
    map_spec = MapState(
        data_x=P(AXIS, None), data_y=P(AXIS, None),
        block_coord=P(AXIS, None), active=P(AXIS),
        slot=P(AXIS, None, None, None), n_blocks=P(AXIS),
        mip_x=tuple(P() for _ in range(nl)),
        mip_y=tuple(P() for _ in range(nl)),
        mip_alloc=tuple(P() for _ in range(nl)),
    )
    return DistState(map=map_spec, pose=P(), raycast_pose=P(),
                     vertex=P(None, AXIS, None), normal=P(None, AXIS, None),
                     valid=P(None, AXIS))


def build_halo_worklist(geom, state, t_cw, k, frame_size, budget,
                        margin: float, frustum: bool):
    """Compact the local blocks to exchange: allocated (slot order), and
    — when ``frustum`` — whose CENTER projects inside the margin-padded
    image or lies within 0.5 m of the camera (see module docstring).

    Returns (worklist i32[budget] of slots, cap = dropped, and the total
    qualifying count for overflow accounting)."""
    w, h = frame_size
    cap = geom.capacity
    slot_ids = jnp.arange(cap, dtype=jnp.int32)
    mask = slot_ids < state.n_blocks
    if frustum:
        scale = BLOCK_SIDE * geom.voxel_size
        cx_ = (state.block_coord[:, 0].astype(jnp.float32) + 0.5) * scale
        cy_ = (state.block_coord[:, 1].astype(jnp.float32) + 0.5) * scale
        cz_ = (state.block_coord[:, 2].astype(jnp.float32) + 0.5) * scale
        px_, py_, pz_ = se3.transform_c(t_cw, cx_, cy_, cz_)
        kx, ky, kz = se3.transform_c(k, px_, py_, pz_)
        z = jnp.where(kz == 0, 1e-12, kz)
        u = kx / z
        v = ky / z
        mw, mh = margin * w, margin * h
        in_view = ((kz > 0) & (u >= -mw) & (u < w + mw)
                   & (v >= -mh) & (v < h + mh))
        near = (px_ * px_ + py_ * py_ + pz_ * pz_) < 0.25
        mask = mask & (in_view | near)
    order = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask & (order < budget), order, budget)
    wl = jnp.full((budget,), cap, jnp.int32).at[dest].set(slot_ids,
                                                          mode="drop")
    return wl, jnp.sum(mask.astype(jnp.int32))


def make_dist_step(mesh: Mesh, geom: MapGeometry, field, *, frame_size,
                   iterations, mu, icp_threshold, neg_y=False,
                   filter_input=False, use_gt_pose=False,
                   integration_rate=1, tracking_rate=1, budget=None,
                   halo_budget=None, frustum_halo=True, margin=0.3):
    """Build the jitted sharded frame step.

    ``geom`` is the LOCAL (per-device) geometry: global capacity =
    n_devices * geom.capacity. Returns ``step(state, depth, k, frame,
    gt_pose) -> (state, aux)`` with aux counters: per-device block
    counts, halo block count + overflow, ray/alloc/integration drops.
    """
    d = mesh.devices.size
    w, h = frame_size
    b = geom.blocks_per_side
    cap = geom.capacity
    if budget is None:
        budget = cap
    if halo_budget is None:
        halo_budget = cap
    own = jnp.asarray(owner_grid(geom, d))
    levels = len(iterations)
    unk = raycast._sentinel(field)
    nl = geom.num_levels
    specs = _dist_specs(nl)

    def step_local(lmap_in, pose0, rpose0, vert_c, norm_c, valid_c,
                   depth_c, k, frame, gt_pose):
        idx = jax.lax.axis_index(AXIS)
        lmap = lmap_in._replace(slot=lmap_in.slot[0],
                                n_blocks=lmap_in.n_blocks[0])

        # ---- image halo: full depth + reference maps ------------------
        depth = jax.lax.all_gather(depth_c, AXIS, axis=1, tiled=True)
        ref_v = jax.lax.all_gather(vert_c, AXIS, axis=1, tiled=True)
        ref_n = jax.lax.all_gather(norm_c, AXIS, axis=1, tiled=True)
        ref_ok = jax.lax.all_gather(valid_c, AXIS, axis=1, tiled=True)

        depths, verts, norms, valids = _preprocess_and_pyramid(
            depth, k, levels, neg_y, filter_input)

        # ---- tracking (distributed reduction) or gt bypass ------------
        if use_gt_pose:
            pose = jnp.asarray(gt_pose, jnp.float32)
            tracked = jnp.bool_(True)
            reduction = jnp.zeros((32,), jnp.float32)
        else:
            do_track = (frame % tracking_rate) == 0
            pose_t, tracked_t, reduction, _ = tracking.track(
                pose0, rpose0, k, verts, norms, valids,
                ref_v, ref_n, ref_ok, iterations, icp_threshold,
                axis_name=AXIS, n_shards=d)
            pose = jnp.where(do_track, pose_t, pose0)
            tracked = jnp.where(do_track, tracked_t, False)

        # ---- allocation + integration (local morton range) ------------
        # no-cond gating (the single-chip step's r3 treatment,
        # parallel/step.py): the tracked/rate gate MASKS the touched
        # grid and the integrate writes instead of lax.cond — a cond
        # branch cannot alias the donated pool buffers, forcing a full
        # per-device pool copy-on-write every integrated frame.
        do_integrate = (tracked | (frame <= 3)) \
            & (((frame % integration_rate) == 0) | (frame <= 3))

        # the band/ray march behind the touched grids runs on the
        # device's OWN image columns only (x_offset keeps full-image
        # pixel coords); a psum-OR unions the per-device grids — the
        # march work scales 1/D while the union is an exact match of
        # the replicated full-image mask (same samples, same scatters).
        # Grid bytes on the wire: [B^3] u8 (+ coarse levels for OF),
        # ~0.26 MB at 512^3 — ICI noise next to the brick halo.
        w_loc2 = frame_size[0] // d
        x0a = idx * w_loc2
        dslice = jax.lax.dynamic_slice_in_dim(depths[0], x0a, w_loc2, 1)

        def _union(mask):
            return jax.lax.psum(mask.astype(jnp.uint8), AXIS) > 0

        if field.multiscale_alloc:
            touched, extra = allocation.ofusion_touched_masks(
                geom, dslice, pose, k, mu, x_offset=x0a)
            touched = _union(touched)
            extra = tuple(None if e is None else _union(e) & do_integrate
                          for e in extra)
        else:
            touched = allocation.tsdf_touched_mask(
                geom, dslice, pose, k, mu, x_offset=x0a)
            touched = _union(touched)
            extra = None
        t_local = touched & (own == idx) & do_integrate
        lmap, astats = m.allocate_blocks(geom, lmap, t_local,
                                         with_stats=True)
        # replicated mip existence needs GLOBAL occupancy
        occ = jax.lax.psum((lmap.slot >= 0).astype(jnp.float32),
                           AXIS) > 0
        lmap = m.refresh_mip_alloc(geom, lmap, occ, extra_levels=extra)
        lmap, istats = integration.integrate(
            geom, lmap, field, depth, pose, k, mu,
            (1.0 / 30.0) * frame.astype(jnp.float32), frame_size,
            budget=budget, with_stats=True, when=do_integrate)
        alloc_overflow = jax.lax.psum(
            jnp.where(do_integrate, astats["alloc_overflow"], 0), AXIS)
        blocks_truncated = jax.lax.psum(istats["blocks_truncated"], AXIS)

        # ---- halo exchange + raycast of local columns ------------------
        def raycast_branch(_):
            t_cw = se3.inverse(pose)
            K = se3.camera_matrix(k)
            wl, n_halo = build_halo_worklist(
                geom, lmap, t_cw, K, frame_size, halo_budget, margin,
                frustum_halo)
            present = wl < cap
            slots = jnp.minimum(wl, cap - 1)
            bc = lmap.block_coord[slots]
            cells = ((bc[:, 0] * b + bc[:, 1]) * b + bc[:, 2])
            cells = jnp.where(present, cells, b ** 3)
            # dtype MUST follow the same bucket-size rule as the
            # single-chip strip table (raycast.strips_dtype) or the two
            # raycast paths march at different precisions and the dist
            # trajectory diverges from single-device (r4 regression:
            # f32 single vs bf16 halo cost 6.3 mm by frame 4).
            dt = raycast.strips_dtype(d * halo_budget)
            vals = jnp.where(lmap.data_y[slots] == 0, unk,
                             lmap.data_x[slots]).astype(dt)
            vals = jnp.where(present[:, None], vals, jnp.asarray(unk, dt))

            # the halo all-gather: D x halo_budget bricks (2-4 KB each,
            # dtype per raycast.strips_dtype)
            cells_g = jax.lax.all_gather(cells, AXIS, tiled=True)
            vals_g = jax.lax.all_gather(vals, AXIS, axis=0, tiled=True)
            nhalo = cells_g.shape[0]

            # global addressing over the halo table
            gslot = jnp.full((b ** 3 + 1,), -1, jnp.int32)
            gslot = gslot.at[cells_g].set(
                jnp.arange(nhalo, dtype=jnp.int32), mode="drop")[:-1]
            occupied = (gslot >= 0).reshape(b, b, b)
            dist = jnp.where(occupied, 0.0, float(raycast.MAX_JUMP))
            for _ in range(raycast.MAX_JUMP - 1):
                neigh = -jax.lax.reduce_window(
                    -dist, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1),
                    "SAME")
                dist = jnp.minimum(dist, neigh + 1.0)
            e = dist.astype(jnp.int32).reshape(-1)
            if field.name == "ofusion":
                halo_state = lmap._replace(slot=gslot.reshape(b, b, b))
                cval, have = raycast.coarse_cell_grid(geom, halo_state)
                known_free = (have & (cval <= 0.0)).reshape(-1)
                q = jnp.round(jnp.clip(-cval, 0.0, 1000.0) * 16.0) \
                    .astype(jnp.int32).reshape(-1)
                e = e + jnp.where(known_free, 8 + (q << 4), 0)
            nav = jnp.where(gslot >= 0, gslot, -(1 + e))

            vals_pad = jnp.concatenate(
                [jnp.full((1, BLOCK_VOXELS), unk, dt), vals_g])
            ncells = jnp.where(cells_g < b ** 3, cells_g + b * b, b ** 3)
            ncells = jnp.where((cells_g // (b * b)) + 1 < b, ncells,
                               b ** 3)
            gpad = jnp.concatenate([gslot, jnp.full((1,), -1, jnp.int32)])
            nslot = gpad[jnp.minimum(ncells, b ** 3)]
            nvals = vals_pad[
                jnp.concatenate([jnp.full((1,), 0, jnp.int32), nslot + 1])]
            halo_strips = jnp.concatenate(
                [vals_pad.reshape(nhalo + 1, 64, 8),
                 nvals.reshape(nhalo + 1, 64, 8)], axis=-1).reshape(-1, 16)

            # rays of this device's image columns
            w_loc = w // d
            x0 = idx * w_loc
            xs = (jnp.arange(w_loc, dtype=jnp.float32)
                  + x0.astype(jnp.float32))
            ys = jnp.arange(h, dtype=jnp.float32)
            px, py = jnp.meshgrid(xs, ys, indexing="xy")
            view = jnp.matmul(pose, se3.inverse_camera_matrix(k),
                              precision=jax.lax.Precision.HIGHEST)
            dxr, dyr, dzr = se3.rotate_c(view, px, py, jnp.ones_like(px))
            inv = jax.lax.rsqrt(dxr * dxr + dyr * dyr + dzr * dzr)
            dx = (dxr * inv).reshape(-1)
            dy = (dyr * inv).reshape(-1)
            dz = (dzr * inv).reshape(-1)
            origin = view[:3, 3]
            prime = raycast.prime_from_depth(depth, k).reshape(h, w)
            prime = jax.lax.dynamic_slice_in_dim(prime, x0, w_loc, 1) \
                .reshape(-1)

            # same zcos helper on the same view matrix as the single-
            # chip path (raycast.raycast) — OF band stepping must march
            # identically or dist/single parity breaks (CLAUDE.md rule)
            zcos = (raycast.camera_zcos(view, dx, dy, dz)
                    if field.name == "ofusion" else None)
            (vx, vy, vz, nx, ny, nz, hit, ok, overflow) = \
                raycast.raycast_rays(geom, field, origin, dx, dy, dz, mu,
                                     nav=nav, strips=halo_strips,
                                     prime_t=prime, zcos=zcos)
            vertex = jnp.stack([jnp.where(hit, vx, 0.0),
                                jnp.where(hit, vy, 0.0),
                                jnp.where(hit, vz, 0.0)],
                               axis=-1).reshape(h, w_loc, 3)
            normal = jnp.stack([nx, ny, nz], axis=-1).reshape(h, w_loc, 3)
            return (vertex, normal, ok.reshape(h, w_loc),
                    jax.lax.psum(overflow, AXIS),
                    jax.lax.psum(jnp.maximum(n_halo - halo_budget, 0),
                                 AXIS),
                    jax.lax.psum(jnp.minimum(n_halo, halo_budget), AXIS))

        def keep_maps(_):
            return (vert_c, norm_c, valid_c, jnp.int32(0), jnp.int32(0),
                    jnp.int32(0))

        do_raycast = frame > 2
        vertex, normal, valid, ray_overflow, halo_overflow, halo_blocks = \
            jax.lax.cond(do_raycast, raycast_branch, keep_maps, None)
        raycast_pose = jnp.where(do_raycast, pose, rpose0)

        lmap_out = lmap._replace(slot=lmap.slot[None],
                                 n_blocks=lmap.n_blocks[None])
        aux = {"tracked": tracked, "integrated": do_integrate,
               "reduction": reduction,
               "n_blocks_dev": lmap.n_blocks[None],
               "alloc_overflow": alloc_overflow,
               "blocks_truncated": blocks_truncated,
               "ray_overflow": ray_overflow,
               "halo_overflow": halo_overflow,
               "halo_blocks": halo_blocks}
        return (lmap_out, pose, raycast_pose, vertex, normal, valid, aux)

    aux_spec = {"tracked": P(), "integrated": P(), "reduction": P(),
                "n_blocks_dev": P(AXIS), "alloc_overflow": P(),
                "blocks_truncated": P(), "ray_overflow": P(),
                "halo_overflow": P(), "halo_blocks": P()}
    sharded = jax.shard_map(
        step_local, mesh=mesh,
        in_specs=(specs.map, P(), P(), specs.vertex, specs.normal,
                  specs.valid, P(None, AXIS), P(), P(), P()),
        out_specs=(specs.map, P(), P(), specs.vertex, specs.normal,
                   specs.valid, aux_spec),
        check_vma=False)

    @functools.partial(jax.jit, donate_argnames=("state",))
    def step(state: DistState, depth, k, frame, gt_pose=None):
        # donation lets the per-device pool buffers update in place
        # (callers consume the state exactly once per frame, like the
        # single-chip frame_step)
        if gt_pose is None:
            gt_pose = jnp.eye(4, dtype=jnp.float32)
        lmap, pose, rpose, vertex, normal, valid, aux = sharded(
            state.map, state.pose, state.raycast_pose, state.vertex,
            state.normal, state.valid, depth, k, frame, gt_pose)
        return DistState(map=lmap, pose=pose, raycast_pose=rpose,
                         vertex=vertex, normal=normal, valid=valid), aux

    return step
