"""Voxel-block allocation from depth frames.

Behavioral reference: kfusion/alloc_impl.hpp (TSDF: allocate the +/- band
around each depth sample) and bfusion/alloc_impl.hpp (occupancy: march the
whole camera->surface ray, allocating coarser octants further from the
surface band).

Design: the reference's atomic append-to-list + sort + unique
(octree.hpp:792-817) becomes a dense boolean scatter — every marched
sample sets a bit in a [B,B,B] block-touched grid (dedup for free), and
``core.map.allocate_blocks`` turns the grid into pool slots with one
prefix sum. Because the occupancy step schedule depends only on distance
travelled (compute_stepsize, bfusion/alloc_impl.hpp:37-45), the sample
ladder is *static*, so the whole multi-scale march is one fixed-shape
gather/scatter program.
"""

import math

import jax
import jax.numpy as jnp

from supereight_tpu.constants import BLOCK_SIDE
from supereight_tpu.core import se3
from supereight_tpu.core import map as m


def _pixel_rays_c(depth, pose, k):
    return _pixel_rays_c_sub(depth, pose, k, 1)


def _pixel_rays_c_sub(depth, pose, k, stride: int, x_offset=0):
    """World-space surface points and ray directions toward the camera.

    Mirrors the shared preamble of both allocators: worldVertex =
    pose * invK * ((x+.5)d, (y+.5)d, d), direction = normalize(cam - wv).
    Component arrays out (shape discipline, se3.transform_c).
    ``stride`` > 1 means ``depth`` is a [::stride, ::stride] subsample of
    the full frame; pixel coordinates are scaled to match.
    """
    h, w = depth.shape
    inv_k = se3.inverse_camera_matrix(k)
    kpose = jnp.matmul(pose, inv_k, precision=jax.lax.Precision.HIGHEST)
    # ``x_offset`` (full-image pixels, may be traced): ``depth`` is a
    # column slice starting there — the sharded allocation march
    # (parallel/dist_step.py) marches only the device's own columns
    xs = (jnp.arange(w, dtype=jnp.float32) * stride + 0.5
          + jnp.asarray(x_offset, jnp.float32))
    ys = jnp.arange(h, dtype=jnp.float32) * stride + 0.5
    px, py = jnp.meshgrid(xs, ys, indexing="xy")
    wvx, wvy, wvz = se3.transform_c(kpose, px * depth, py * depth, depth)
    camera = pose[:3, 3]
    dx = camera[0] - wvx
    dy = camera[1] - wvy
    dz = camera[2] - wvz
    norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / jnp.where(norm == 0, 1.0, norm)
    return (wvx, wvy, wvz), (dx * inv, dy * inv, dz * inv), camera


def _touched_cell_ids(geom, lvl, x, y, z, valid):
    """Flat octant ids (level ``lvl``) of sample positions; invalid or
    out-of-map samples map to the drop bucket ``side^3``."""
    side = geom.blocks_per_side >> lvl
    vx = jnp.floor(x * geom.inv_voxel_size).astype(jnp.int32)
    vy = jnp.floor(y * geom.inv_voxel_size).astype(jnp.int32)
    vz = jnp.floor(z * geom.inv_voxel_size).astype(jnp.int32)
    inb = ((vx >= 0) & (vx < geom.size) & (vy >= 0) & (vy < geom.size)
           & (vz >= 0) & (vz < geom.size)) & valid
    shift = 3 + lvl
    flat = ((vx >> shift) * side + (vy >> shift)) * side + (vz >> shift)
    return jnp.where(inb, flat, side * side * side)


def tsdf_touched_mask(geom, depth, pose, k, mu: float, x_offset=0):
    """Blocks intersected by the +/- 2*mu band around each depth sample
    (ref buildAllocationList, kfusion/alloc_impl.hpp:53-118).

    The reference samples every voxel along the band; since only the set
    of touched 8^3 *blocks* matters, sampling every 3 voxels cuts the
    scatter volume 3x while still hitting every block the ray spends >3
    voxels in (a corner-clipped block can be picked up a frame later —
    a scatter pays per UPDATE including dropped ones, so the sample
    count is the stage's whole cost). Pixels are likewise sampled 2x2: adjacent rays
    are a few mm apart at range — far below the 8-voxel block size — so
    the touched-block set is essentially unchanged."""
    b = geom.blocks_per_side
    band = 2.0 * mu
    num_steps = int(math.ceil(band * geom.inv_voxel_size / 3.0))
    depth = depth[::2, ::2]
    (wvx, wvy, wvz), (dx, dy, dz), _ = _pixel_rays_c_sub(depth, pose, k, 2,
                                                         x_offset)
    ox = wvx - (band * 0.5) * dx
    oy = wvy - (band * 0.5) * dy
    oz = wvz - (band * 0.5) * dz
    step = band / num_steps
    valid = depth > 0
    flat = jnp.zeros((b * b * b + 1,), bool)
    ids = []
    for i in range(num_steps):        # sample dim unrolled: [h, w] tensors
        t = i * step
        ids.append(_touched_cell_ids(geom, 0, ox + dx * t, oy + dy * t,
                                     oz + dz * t, valid))
    stacked = jnp.stack(ids)
    # consecutive band samples mostly stay in the same 8-voxel block
    # (2-voxel steps): route duplicates to the drop bucket — a scatter
    # pays per UPDATE, and this drops ~70% of the 200k+ updates
    dup = stacked[1:] == stacked[:-1]
    stacked = jnp.concatenate(
        [stacked[:1],
         jnp.where(dup, b * b * b, stacked[1:])])
    flat = flat.at[stacked.reshape(-1)].set(True, mode="drop")
    return flat[:-1].reshape(b, b, b)


def ofusion_step_ladder(geom, band: float, max_dist: float):
    """Static (travelled-distance, mip-level) schedule of the occupancy
    ray march (ref compute_stepsize + step_to_depth,
    bfusion/alloc_impl.hpp:37-51).

    Depth 'max_depth' maps to voxel steps handled at block level (ref
    clamps allocation depth to the leaves level); 10x/30x voxel steps land
    on mip levels 1 and 2 (octant sides 16 and 64... sides 16 and 32).
    """
    voxel = geom.voxel_size
    travelled = []
    levels = []
    t = 0.0
    while t < max_dist:
        travelled.append(t)
        if t < band:
            step, lvl = voxel, 0
        elif t < band * 1.5:
            step, lvl = 10.0 * voxel, 1
        else:
            step, lvl = 30.0 * voxel, 2
        # level of the *next* sample derives from this step size
        # (the first sample is always at block level, tree_depth=max_depth)
        levels.append(lvl)
        t += step
    # level[i] applies to sample i+1; sample 0 is block level.
    sample_levels = [0] + levels[:-1]
    return travelled, sample_levels


def ofusion_touched_masks(geom, depth, pose, k, mu: float,
                          max_dist: float = None, x_offset=0):
    """Per-level touched masks for occupancy allocation
    (ref buildOctantList, bfusion/alloc_impl.hpp:53-129).

    Returns (block_touched [B,B,B], extra_levels tuple for
    ``refresh_mip_alloc`` with masks at levels 1 and 2). Pixels are
    sampled 2x2 like the TSDF allocator (touched-octant sets are
    insensitive to sub-block ray spacing; scatters cost per element).
    """
    band = 6.0 * mu
    if max_dist is None:
        max_dist = geom.dim * math.sqrt(3.0)
    travelled, sample_levels = ofusion_step_ladder(geom, band, max_dist)

    b = geom.blocks_per_side
    masks = {}
    for lvl in sorted(set(sample_levels)):
        side = b >> lvl
        # per-level pixel stride: the fine band level samples 2x2 (see
        # tsdf_touched_mask); the COARSE free-space levels sample 8x8 —
        # a level-1/2 octant is 16-32 voxels across, so 2px-spaced rays
        # land in the same octants thousands of times over, and a
        # scatter pays per UPDATE, duplicates included. An octant grazed by no
        # sparse ray this frame is re-touched the next while observed.
        stride = 2 if lvl == 0 else 8
        dsub = depth[::stride, ::stride]
        (wvx, wvy, wvz), (dx, dy, dz), camera = _pixel_rays_c_sub(
            dsub, pose, k, stride, x_offset)
        ox = wvx - (band * 0.5) * dx
        oy = wvy - (band * 0.5) * dy
        oz = wvz - (band * 0.5) * dz
        dist = jnp.sqrt((camera[0] - ox) ** 2 + (camera[1] - oy) ** 2
                        + (camera[2] - oz) ** 2)
        valid0 = dsub > 0
        ids = []
        for i, l in enumerate(sample_levels):
            if l != lvl:
                continue
            t = travelled[i]
            ids.append(_touched_cell_ids(
                geom, lvl, ox + dx * t, oy + dy * t, oz + dz * t,
                valid0 & (t < dist)))
        stacked = jnp.stack(ids)
        # consecutive same-ray samples mostly stay in one octant at the
        # coarse levels: route duplicates to the drop bucket (scatters
        # cost per update — same dedup as tsdf_touched_mask)
        if stacked.shape[0] > 1:
            dup = stacked[1:] == stacked[:-1]
            stacked = jnp.concatenate(
                [stacked[:1],
                 jnp.where(dup, side ** 3, stacked[1:])])
        flat = jnp.zeros((side ** 3 + 1,), bool)
        flat = flat.at[stacked.reshape(-1)].set(True, mode="drop")
        masks[lvl] = flat[:-1].reshape(side, side, side)
    for lvl in (0, 1, 2):
        if lvl not in masks:
            side = b >> lvl
            masks[lvl] = jnp.zeros((side,) * 3, bool)

    extra = [None] * geom.num_levels
    if geom.num_levels > 1:
        extra[1] = masks[1]
    if geom.num_levels > 2:
        extra[2] = masks[2]
    return masks[0], tuple(extra)


def allocate_tsdf(geom, state, depth, pose, k, mu: float,
                  with_stats: bool = False, when=None, budget: int = None):
    """Full TSDF allocation step: band march -> block pool update.

    ``when`` (optional traced bool scalar) masks the whole allocation —
    the no-cond gating of the fused frame step (see
    ops/integration.integrate's ``when``): with it False the touched set
    is empty and the pool is unchanged.
    """
    touched = tsdf_touched_mask(geom, depth, pose, k, mu)
    if when is not None:
        touched = touched & when
    return m.allocate_blocks(geom, state, touched, with_stats=with_stats,
                             budget=budget)


def allocate_ofusion(geom, state, depth, pose, k, mu: float,
                     with_stats: bool = False, when=None,
                     budget: int = None):
    """Full occupancy allocation step: multi-scale march -> pool + mips."""
    touched, extra = ofusion_touched_masks(geom, depth, pose, k, mu)
    if when is not None:
        touched = touched & when
        extra = tuple(e & when if e is not None else None for e in extra)
    out = m.allocate_blocks(geom, state, touched, with_stats=with_stats,
                            budget=budget)
    state, stats = out if with_stats else (out, None)
    state = m.refresh_mip_alloc(geom, state, state.slot >= 0,
                                extra_levels=extra)
    return (state, stats) if with_stats else state
