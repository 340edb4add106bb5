"""Whole-map and AABB-scoped voxel transforms.

Behavioral reference: se::functor::axis_aligned
(se_core/include/se/functors/axis_aligned_functor.hpp:118-131) — apply a
function to every voxel (and coarse octant value) inside an axis-aligned
box, defaulting to the whole map.

Device shape: the per-block pass is a batched transform over [capacity, 512]
with an in-box mask; the node pass maps over the dense mips. The functor
receives (x, y, voxel_coords) and returns (x, y) — the data_handler
get/set indirection (data_handler.hpp:44-81) collapses into pure array
updates.
"""

import jax.numpy as jnp
import numpy as np

from supereight_tpu.constants import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu.core.map import MapState

_LIN = np.arange(BLOCK_VOXELS, dtype=np.int32)
_LOCAL = np.stack([_LIN % 8, (_LIN // 8) % 8, _LIN // 64], axis=-1)


def axis_aligned_map(geom, state: MapState, fn, bbox_min=None,
                     bbox_max=None, include_nodes=True) -> MapState:
    """Apply ``fn(x, y, vox_coords) -> (x, y)`` to all allocated voxels in
    the box (whole map by default), and optionally to coarse octant
    values (the reference's node pass)."""
    cap = geom.capacity
    if bbox_min is None:
        bbox_min = (0, 0, 0)
    if bbox_max is None:
        bbox_max = (geom.size,) * 3
    lo = jnp.asarray(bbox_min, jnp.int32)
    hi = jnp.asarray(bbox_max, jnp.int32)

    slot_ids = jnp.arange(cap)[:, None]
    allocated = slot_ids < state.n_blocks            # [cap, 1]
    vox = state.block_coord[:, None, :] * BLOCK_SIDE + _LOCAL[None]
    in_box = jnp.all((vox >= lo) & (vox < hi), axis=-1)
    mask = allocated & in_box
    nx, ny = fn(state.data_x, state.data_y, vox)
    state = state._replace(
        data_x=jnp.where(mask, nx, state.data_x),
        data_y=jnp.where(mask, ny, state.data_y))

    if include_nodes:
        new_x, new_y = [], []
        for lvl in range(geom.num_levels):
            side = geom.blocks_per_side >> lvl
            octant_vox = BLOCK_SIDE << lvl
            g = jnp.arange(side, dtype=jnp.int32)
            gx, gy, gz = jnp.meshgrid(g, g, g, indexing="ij")
            coords = jnp.stack([gx, gy, gz], axis=-1) * octant_vox
            in_box = jnp.all((coords >= lo) & (coords < hi), axis=-1)
            mask = state.mip_alloc[lvl] & in_box
            nx, ny = fn(state.mip_x[lvl], state.mip_y[lvl], coords)
            new_x.append(jnp.where(mask, nx, state.mip_x[lvl]))
            new_y.append(jnp.where(mask, ny, state.mip_y[lvl]))
        state = state._replace(mip_x=tuple(new_x), mip_y=tuple(new_y))
    return state
