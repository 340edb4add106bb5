"""Projective map integration (fusion).

Behavioral reference: se::functor::projective_functor
(se_core/include/se/functors/projective_functor.hpp:54-156): gather the
active+in-frustum block list, update every voxel of those blocks with the
field functor, then update the coarse node values.

Design: the active list is a fixed-budget compaction (prefix sum over
the slot mask, like the reference's parallel filter,
algorithms/filter.hpp:61-107); the per-block 8x8x8 voxel update is a
single batched program of shape [budget, 512]. The stage cost is the
per-voxel depth fetch, done as 8-pixel STRIP rows + a log2
lane-select tree (on the earlier accelerator the strip form beat a
flat element gather ~3x in-program; unmeasured on the H100).
The node pass is a dense update over
each mip level gated by mip_alloc. Coordinates are carried as separate
x/y/z arrays of shape [budget, 512] (large minor dim; no [..., 3]
stacking — see se3.transform_c).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from supereight_tpu.constants import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu.core import se3
from supereight_tpu.utils.loops import lane_select
from supereight_tpu.fields import tsdf as tsdf_field
from supereight_tpu.fields import ofusion as ofusion_field

# local voxel offsets in brick-linear order (x + 8y + 64z)
# numpy constants: creating jnp arrays at import would initialize the
# default backend as a side effect of importing the module
_LIN = np.arange(BLOCK_VOXELS, dtype=np.int32)
_LOCAL_X = _LIN % 8
_LOCAL_Y = (_LIN // 8) % 8
_LOCAL_Z = _LIN // 64


def in_frustum_mask(geom, state, t_cw, k, frame_size):
    """Per-slot frustum predicate (ref algorithms::in_frustum,
    filter.hpp:37-49): project the block's origin corner."""
    w, h = frame_size
    scale = BLOCK_SIDE * geom.voxel_size
    ox = state.block_coord[:, 0].astype(jnp.float32) * scale
    oy = state.block_coord[:, 1].astype(jnp.float32) * scale
    oz = state.block_coord[:, 2].astype(jnp.float32) * scale
    cx, cy, cz = se3.transform_c(t_cw, ox, oy, oz)
    px_, py_, pz_ = se3.transform_c(k, cx, cy, cz)
    z = jnp.where(pz_ == 0, 1e-12, pz_)
    px = (px_ / z).astype(jnp.int32)
    py = (py_ / z).astype(jnp.int32)
    return (z > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)


def build_active_worklist(geom, state, t_cw, k, frame_size, budget: int):
    """Fixed-budget compaction of active ∩ in-frustum slots
    (ref build_active_list, projective_functor.hpp:54-71).

    Returns (i32[budget] slot ids — empty entries = capacity, dropped on
    scatter —, total active∧in-frustum count for overflow accounting)."""
    cap = geom.capacity
    slot_ids = jnp.arange(cap, dtype=jnp.int32)
    allocated = slot_ids < state.n_blocks
    mask = allocated & state.active & in_frustum_mask(geom, state, t_cw, k,
                                                      frame_size)
    order = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask & (order < budget), order, budget)
    worklist = jnp.full((budget,), cap, jnp.int32)
    return (worklist.at[dest].set(slot_ids, mode="drop"),
            jnp.sum(mask.astype(jnp.int32)))


def _project_voxels_c(geom, wx, wy, wz, t_cw, k, frame_size):
    """Camera-frame position + pixel coords + validity for sample points.

    Mirrors update_block's projection (projective_functor.hpp:85-103):
    pixel = K*pos / z + 0.5, valid when z >= 1e-4 and pixel in
    [0.5, size-1.5]. Component arrays in, component arrays out.
    """
    w, h = frame_size
    cx, cy, cz = se3.transform_c(t_cw, wx, wy, wz)
    kx, ky, kz = se3.transform_c(k, cx, cy, cz)
    safe = jnp.where(kz == 0, 1e-12, kz)
    px = kx / safe + 0.5
    py = ky / safe + 0.5
    valid = ((cz >= 1e-4)
             & (px >= 0.5) & (px <= w - 1.5)
             & (py >= 0.5) & (py <= h - 1.5))
    return (cx, cy, cz), px, py, valid


def _sample_depth(depth, px, py):
    """Nearest-neighbour depth fetch at truncated pixel coords
    (ref sdf_update AND bfusion_update both read depth[int(pixel)] —
    kfusion/mapping_impl.hpp:39-41, bfusion/mapping_impl.hpp:163-164;
    the bilinear interpDepth at bfusion/mapping_impl.hpp:41-92 is
    defined but never called in the reference).

    8-pixel strip row fetch + log2 lane-select tree — measured fastest
    IN the full integrate program (see module docstring); exact same
    sample as an element gather."""
    h, w = depth.shape
    xi = jnp.clip(px.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(py.astype(jnp.int32), 0, h - 1)
    ws = (w + 7) // 8
    if w % 8:
        depth = jnp.pad(depth, ((0, 0), (0, ws * 8 - w)))
    strips = depth.reshape(h * ws, 8)
    row = strips[yi * ws + (xi >> 3)]                  # [..., 8]
    return lane_select(row, xi & 7)


_PATCH_LEVELS = 3
# bound on blocks taking the exact per-voxel fallback gather per frame
_FALLBACK_BLOCKS = 32


def _sample_depth_patch(depth, px, py, valid):
    """Per-BLOCK patch depth fetch — the hot-path form of the nearest
    sample (same semantics as :func:`_sample_depth`: both read
    depth[int(pixel)], ref kfusion/mapping_impl.hpp:39-41).

    A block's 512 voxels project into a small pixel bbox, so instead of
    one gathered row per voxel (budget*512 rows), fetch one 16-row x
    32-px patch per block (32 rows) and select per voxel with a one-hot
    contraction over x plus a 16-wide lane tree over y — bit-exact where
    the patch covers. Whether it still beats the per-voxel gather on the
    H100 is unmeasured.

    Blocks whose bbox exceeds the patch (footprint > 24 px wide or
    > 15 px tall, i.e. closer than ~1.1 m at the bench intrinsics) use
    the same patch against a 2x- or 4x-subsampled depth mip: those
    blocks' voxels sample the depth grid at stride 2/4 — a DOCUMENTED
    deviation (the reference reads the exact pixel); at that range
    voxel spacing exceeds the stride so the error is bounded by
    adjacent-pixel depth noise. The x thresholds are the GUARANTEED
    patch coverage (the 32-lane window is 8-px aligned, wasting up to
    7 level-px left of the bbox — ADVICE r3), and levels whose mip is
    too small for the 16x3-strip patch geometry are statically disabled
    (small computation sizes, ADVICE r3). Voxels still outside every
    usable patch fall back to the exact per-voxel gather in
    :func:`integrate` (bounded sub-worklist), so no update is silently
    coarser than the reference's.

    Returns (depth_sample [budget, 512], in_patch [budget, 512]).
    """
    h, w = depth.shape
    tables, offs, wss, hs = [], [], [], []
    off = 0
    for lv in range(_PATCH_LEVELS):
        d = depth[:: 1 << lv, :: 1 << lv]
        hl, wl = d.shape
        ws = (wl + 7) // 8
        if hl < 16 or ws < 3:
            break  # level mip too small for the patch geometry
        tables.append(_depth_strips16(d))
        offs.append(off)
        wss.append(ws)
        hs.append(hl)
        off += hl * ws
    if not tables:  # depth image too small for any patch level
        return jnp.zeros(px.shape, depth.dtype), jnp.zeros(px.shape, bool)
    table = jnp.concatenate(tables, 0)
    n_lv = len(tables)

    xi = jnp.clip(px.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(py.astype(jnp.int32), 0, h - 1)
    big = 1 << 20
    x0 = jnp.min(jnp.where(valid, xi, big), axis=1)
    x1 = jnp.max(jnp.where(valid, xi, -1), axis=1)
    y0 = jnp.min(jnp.where(valid, yi, big), axis=1)
    y1 = jnp.max(jnp.where(valid, yi, -1), axis=1)
    dx = x1 - x0
    dy = y1 - y0
    lvl = jnp.zeros_like(dx)
    for i in range(1, n_lv):
        lvl = jnp.where((dx > (24 << (i - 1))) | (dy > (15 << (i - 1))),
                        i, lvl)
    covered = (dx <= (24 << (n_lv - 1))) & (dy <= (15 << (n_lv - 1)))

    def sel(vs):
        return jnp.asarray(vs, jnp.int32)[lvl]

    ws_l = sel(wss)
    h_l = sel(hs)
    off_l = sel(offs)
    xl0 = jnp.clip(x0, 0, w - 1) >> lvl
    yl0 = jnp.clip(y0, 0, h - 1) >> lvl
    s0 = jnp.clip(xl0 >> 3, 0, ws_l - 3)
    yc0 = jnp.clip(yl0, 0, h_l - 16)
    ys = yc0[:, None] + jnp.arange(16, dtype=jnp.int32)[None]
    rid = off_l[:, None] + ys * ws_l[:, None] + s0[:, None]
    rows0 = table[rid]                                 # [budget, 16, 16]
    rows1 = table[rid + 2]
    patch = jnp.concatenate([rows0, rows1], axis=-1)   # [budget, 16, 32]
    xx = (xi >> lvl[:, None]) - (s0 << 3)[:, None]
    yy = (yi >> lvl[:, None]) - yc0[:, None]
    in_patch = ((xx >= 0) & (xx < 32) & (yy >= 0) & (yy < 16)
                & covered[:, None])
    # one-hot x contraction: exact selection (operand is exactly 0/1;
    # HIGHEST keeps the f32 depth bits — measured maxerr 0)
    onex = (xx[..., None] == jnp.arange(32, dtype=jnp.int32)[None, None]
            ).astype(jnp.float32)
    rowv = jnp.einsum("bvx,byx->bvy", onex, patch,
                      precision=jax.lax.Precision.HIGHEST)
    val = lane_select(rowv, jnp.clip(yy, 0, 15))
    return val, in_patch


def _depth_strips16(depth):
    """[h*ws, 16] rows: 8 pixels of a strip + the 8 of the next strip,
    so an (x, x+1) bilinear pair is one row fetch (same trick as
    raycast.build_strips)."""
    h, w = depth.shape
    ws = (w + 7) // 8
    if w % 8:
        depth = jnp.pad(depth, ((0, 0), (0, ws * 8 - w)))
    left = depth.reshape(h, ws, 8)
    right = jnp.concatenate([left[:, 1:], jnp.zeros((h, 1, 8))], axis=1)
    return jnp.concatenate([left, right], axis=-1).reshape(h * ws, 16)


def _sample_depth_bilinear(depth, px, py):
    """Bilinear depth filtering in inverse-depth space — the reference's
    interpDepth (bfusion/mapping_impl.hpp:41-92), offered as an OPT-IN
    (``Configuration.depth_interp``): the reference defines it but its
    bfusion_update functor actually samples nearest-neighbour
    (mapping_impl.hpp:163-164), so nearest is the parity default.

    Semantics kept: inverse-depth bilinear over the 2x2 neighbourhood;
    0 if any neighbour is missing; nearest-neighbour fallback when the
    filtered value disagrees with any neighbour by > 5 cm.

    Two 16-lane strip rows (y0, y1) supply all four corners.
    """
    h, w = depth.shape
    ws = (w + 7) // 8
    strips = _depth_strips16(depth)
    x0f = jnp.floor(px - 0.5)
    y0f = jnp.floor(py - 0.5)
    fx = (px - 0.5) - x0f
    fy = (py - 0.5) - y0f
    x0 = jnp.clip(x0f.astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 2)
    lane = x0 & 7
    row0 = strips[y0 * ws + (x0 >> 3)]
    row1 = strips[(y0 + 1) * ws + (x0 >> 3)]
    d00 = lane_select(row0, lane)
    d10 = lane_select(row0, lane + 1)
    d01 = lane_select(row1, lane)
    d11 = lane_select(row1, lane + 1)
    any_zero = (d00 == 0) | (d10 == 0) | (d01 == 0) | (d11 == 0)
    safe = lambda d: jnp.where(d == 0, 1.0, d)
    inv = ((1.0 / safe(d00)) * (1 - fx) * (1 - fy)
           + (1.0 / safe(d10)) * fx * (1 - fy)
           + (1.0 / safe(d01)) * (1 - fx) * fy
           + (1.0 / safe(d11)) * fx * fy)
    d = 1.0 / inv
    thr = 0.05
    consistent = ((jnp.abs(d - d00) < thr) & (jnp.abs(d - d10) < thr)
                  & (jnp.abs(d - d01) < thr) & (jnp.abs(d - d11) < thr))
    nearest = _sample_depth(depth, px, py)
    out = jnp.where(consistent, d, nearest)
    return jnp.where(any_zero, 0.0, out)


def _field_update(field, old_x, old_y, pos_cam, depth_sample, valid, *,
                  mu, timestamp, voxel_size, noise_weighted=False):
    if field.name == "tsdf":
        return tsdf_field.update(old_x, old_y, pos_cam, depth_sample, mu,
                                 valid, noise_weighted=noise_weighted)
    return ofusion_field.update(old_x, old_y, pos_cam, depth_sample, mu,
                                timestamp, voxel_size, valid)


@functools.partial(jax.jit,
                   static_argnames=("geom", "field", "frame_size", "budget",
                                    "depth_interp", "with_stats",
                                    "noise_weighted"))
def integrate(geom, state, field, depth, pose, k, mu, timestamp,
              frame_size, budget: int = 8192, depth_interp: bool = False,
              with_stats: bool = False, when=None,
              noise_weighted: bool = False):
    """One fusion pass: block update + node (mip) update
    (ref projective_functor::apply, projective_functor.hpp:139-156).

    ``pose`` is camera-to-world; the functor uses its inverse (ref
    DenseSLAMSystem.cpp:237). Returns the new map state, plus a stats
    dict when ``with_stats`` (``blocks_truncated``: active∧in-frustum
    blocks beyond ``budget`` that skipped fusion this frame — the
    reference updates every active block, projective_functor.hpp:139-156,
    so a nonzero count means ``budget`` must be raised).

    ``depth_interp`` switches the fusion depth sample to the bilinear
    inverse-depth filter (see :func:`_sample_depth_bilinear`).

    ``when`` (optional traced bool scalar) masks ALL map writes: the
    fused frame step gates integration on tracking success per the
    reference's rate gates (DenseSLAMSystem.cpp:206-212), and masking
    the scatters instead of wrapping the call in ``lax.cond`` lets XLA
    alias the donated pool buffers (a cond branch forces a full
    copy-on-write of the 150+ MB pool every frame).
    """
    t_cw = se3.inverse(pose)
    K = se3.camera_matrix(k)
    cap = geom.capacity
    budget = min(budget, cap)

    # ---- block pass -----------------------------------------------------
    # Compacted worklist of active ∧ in-frustum blocks (ref
    # build_active_list, projective_functor.hpp:54-71): the strip fetch
    # below costs per gathered ROW, so bounding rows to [budget, 512]
    # is the stage's cost knob.
    wl, n_active = build_active_worklist(geom, state, t_cw, K, frame_size,
                                         budget)
    present = wl < cap
    if when is not None:
        present = present & when
    slots = jnp.minimum(wl, cap - 1)

    vs = geom.voxel_size
    bc = state.block_coord[slots]                       # [budget, 3]
    wx = (bc[:, 0:1] * BLOCK_SIDE + _LOCAL_X[None]).astype(jnp.float32) * vs
    wy = (bc[:, 1:2] * BLOCK_SIDE + _LOCAL_Y[None]).astype(jnp.float32) * vs
    wz = (bc[:, 2:3] * BLOCK_SIDE + _LOCAL_Z[None]).astype(jnp.float32) * vs
    (cx, cy, cz), px, py, valid = _project_voxels_c(geom, wx, wy, wz, t_cw,
                                                    K, frame_size)
    valid = valid & present[:, None]
    if depth_interp:
        depth_sample = _sample_depth_bilinear(depth, px, py)
        patch_skipped = jnp.int32(0)
    else:
        depth_sample, in_patch = _sample_depth_patch(depth, px, py, valid)
        # exact per-voxel fallback for blocks with voxels outside every
        # usable patch (oversized footprint / tiny depth image): compact
        # those blocks into a bounded sub-worklist and fetch their rows
        # with the per-voxel strip gather — bit-exact, so only blocks
        # beyond _FALLBACK_BLOCKS (counted) ever skip fusion.
        need = jnp.any(valid & ~in_patch, axis=1)
        fb_budget = min(_FALLBACK_BLOCKS, budget)
        ids = jnp.arange(budget, dtype=jnp.int32)
        fvals, _ = jax.lax.top_k(jnp.where(need, budget - ids, 0), fb_budget)
        fwl = jnp.where(fvals > 0, budget - fvals, -1)
        fwlc = jnp.maximum(fwl, 0)
        fb_val = _sample_depth(depth, px[fwlc], py[fwlc])
        dest = jnp.where(fwl >= 0, fwl, budget)
        depth_sample = depth_sample.at[dest].set(fb_val, mode="drop")
        in_patch = in_patch.at[dest].set(True, mode="drop")
        patch_skipped = jnp.sum((valid & ~in_patch).astype(jnp.int32))
        valid = valid & in_patch

    old_x = state.data_x[slots]
    old_y = state.data_y[slots]
    new_x, new_y, _ = _field_update(field, old_x, old_y, (cx, cy, cz),
                                    depth_sample, valid, mu=mu,
                                    timestamp=timestamp,
                                    voxel_size=geom.voxel_size,
                                    noise_weighted=noise_weighted)
    wl_or_drop = jnp.where(present, wl, cap)
    data_x = state.data_x.at[wl_or_drop].set(new_x, mode="drop")
    data_y = state.data_y.at[wl_or_drop].set(new_y, mode="drop")

    # visibility: block stays active iff any voxel projected into the frame
    # (ref update_block sets block->active(is_visible),
    # projective_functor.hpp:104-110)
    visible = jnp.any(valid, axis=1)
    active = state.active.at[wl_or_drop].set(visible, mode="drop")

    state = state._replace(data_x=data_x, data_y=data_y, active=active)

    # ---- node (coarse mip) pass ----------------------------------------
    # ref update_node (projective_functor.hpp:113-137): every existing
    # coarse value slot is re-fused at its octant origin corner.
    #
    # Level 0 holds (B)^3 octant slots (262k at 512^3) and its existence
    # mask is by construction a 2x2x2 broadcast of "parent node exists"
    # (core/map.refresh_mip_alloc), so it runs SPARSE: compact occupied
    # PARENTS (top_k over (B/2)^3), fetch each parent's 8 children as
    # ONE 8-wide row of a sibling-packed transpose of the dense mip
    # (gathers cost per ROW), update, scatter the rows back. Cost
    # scales with allocated parents instead of the whole grid (the
    # dense form gathered 262k depth rows every frame).
    # Higher levels stay dense ((B/2)^3 + ... cells are cheap).
    mip_skipped = jnp.int32(0)
    first_dense_level = 0
    if geom.blocks_per_side >= 8:
        first_dense_level = 1
        state, mip_skipped = _node_pass_level0_sparse(
            geom, state, field, depth, t_cw, K, frame_size, mu, timestamp,
            min(budget, (geom.blocks_per_side // 2) ** 3), when)

    new_mips_x = [state.mip_x[lvl] for lvl in range(first_dense_level)]
    new_mips_y = [state.mip_y[lvl] for lvl in range(first_dense_level)]
    for lvl in range(first_dense_level, geom.num_levels):
        side = geom.blocks_per_side >> lvl
        octant_m = (BLOCK_SIDE << lvl) * geom.voxel_size
        g = jnp.arange(side, dtype=jnp.float32) * octant_m
        wx = g[:, None, None] + jnp.zeros((side, side, side))
        wy = g[None, :, None] + jnp.zeros((side, side, side))
        wz = g[None, None, :] + jnp.zeros((side, side, side))
        (cx, cy, cz), px, py, valid = _project_voxels_c(
            geom, wx, wy, wz, t_cw, K, frame_size)
        valid = valid & state.mip_alloc[lvl]
        if when is not None:
            valid = valid & when
        ds = _sample_depth(depth, px, py)
        nx, ny, _ = _field_update(field, state.mip_x[lvl], state.mip_y[lvl],
                                  (cx, cy, cz), ds, valid, mu=mu,
                                  timestamp=timestamp,
                                  voxel_size=geom.voxel_size)
        new_mips_x.append(nx)
        new_mips_y.append(ny)

    state = state._replace(mip_x=tuple(new_mips_x), mip_y=tuple(new_mips_y))
    if with_stats:
        truncated = jnp.maximum(n_active - budget, 0)
        if when is not None:
            truncated = jnp.where(when, truncated, 0)
            patch_skipped = jnp.where(when, patch_skipped, 0)
            mip_skipped = jnp.where(when, mip_skipped, 0)
        return state, {"blocks_truncated": truncated,
                       "patch_skipped": patch_skipped,
                       "mip_skipped": mip_skipped}
    return state


def _node_pass_level0_sparse(geom, state, field, depth, t_cw, K,
                             frame_size, mu, timestamp, pbudget: int,
                             when):
    """Sparse level-0 coarse-value update over occupied parents.

    Exactly the dense level-0 update of :func:`integrate`'s node pass
    (ref update_node, projective_functor.hpp:113-137) restricted to the
    2x2x2 sibling groups whose parent node exists — which is ALL slots
    whose ``mip_alloc[0]`` bit is set (refresh_mip_alloc broadcasts
    parent occupancy to every sibling). Parents beyond ``pbudget`` skip
    their update this frame and are counted (returned as mip_skipped
    octants).
    """
    b = geom.blocks_per_side
    hp = b // 2
    npar = hp * hp * hp
    parent = state.mip_alloc[0].reshape(hp, 2, hp, 2, hp, 2) \
        .any(axis=(1, 3, 5)).reshape(-1)

    ids = jnp.arange(npar, dtype=jnp.int32)
    vals, _ = jax.lax.top_k(jnp.where(parent, npar - ids, 0), pbudget)
    pw = jnp.where(vals > 0, npar - vals, -1)
    present = pw >= 0
    pwc = jnp.maximum(pw, 0)
    skipped = (jnp.sum(parent.astype(jnp.int32))
               - jnp.sum(present.astype(jnp.int32))) * 8

    def pack(m):
        return m.reshape(hp, 2, hp, 2, hp, 2) \
            .transpose(0, 2, 4, 1, 3, 5).reshape(npar, 8)

    def unpack(m):
        return m.reshape(hp, hp, hp, 2, 2, 2) \
            .transpose(0, 3, 1, 4, 2, 5).reshape(b, b, b)

    px_ = pack(state.mip_x[0])
    py_ = pack(state.mip_y[0])
    old_x = px_[pwc]
    old_y = py_[pwc]

    # child octant origin corners (the position update_node samples)
    pi = pwc // (hp * hp)
    pj = (pwc // hp) % hp
    pk = pwc % hp
    ci = jnp.asarray(np.arange(8) // 4, jnp.int32)[None]
    cj = jnp.asarray((np.arange(8) // 2) % 2, jnp.int32)[None]
    ck = jnp.asarray(np.arange(8) % 2, jnp.int32)[None]
    octant_m = BLOCK_SIDE * geom.voxel_size
    wx = (pi[:, None] * 2 + ci).astype(jnp.float32) * octant_m
    wy = (pj[:, None] * 2 + cj).astype(jnp.float32) * octant_m
    wz = (pk[:, None] * 2 + ck).astype(jnp.float32) * octant_m
    (cx, cy, cz), ppx, ppy, valid = _project_voxels_c(
        geom, wx, wy, wz, t_cw, K, frame_size)
    valid = valid & present[:, None]
    if when is not None:
        valid = valid & when
    ds = _sample_depth(depth, ppx, ppy)
    nx, ny, _ = _field_update(field, old_x, old_y, (cx, cy, cz), ds,
                              valid, mu=mu, timestamp=timestamp,
                              voxel_size=geom.voxel_size)
    dest = jnp.where(present, pw, npar)
    px_ = px_.at[dest].set(nx, mode="drop")
    py_ = py_.at[dest].set(ny, mode="drop")
    mips_x = (unpack(px_),) + state.mip_x[1:]
    mips_y = (unpack(py_),) + state.mip_y[1:]
    if when is not None:
        skipped = jnp.where(when, skipped, 0)
    return state._replace(mip_x=mips_x, mip_y=mips_y), skipped
