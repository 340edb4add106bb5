"""Accelerator-resident sparse voxel map: block pool + dense mip pyramid.

This is the from-scratch replacement for the reference's pointer octree
(ref: se_core/include/se/octree.hpp, node.hpp). Design:

* **Leaf storage** is a fixed-capacity pool of dense 8x8x8 voxel bricks
  (SoA: two f32 channels of shape [capacity, 512]), the analogue of
  ``se::VoxelBlock`` (node.hpp:89-165) held in ``se::MemoryPool``
  (utils/memory_pool.hpp). Linear voxel index inside a brick is
  x + 8*y + 64*z, the same layout as node.hpp:139-153.

* **Addressing** replaces pointer descent (octree.hpp:441-458 ``fetch``)
  with a dense int32 grid ``slot[bx, by, bz]`` over block coordinates
  mapping to pool slots (-1 = unallocated). O(1) gather, no traversal,
  no data-dependent control flow — ideal for XLA.

* **Internal-node values** (the 8 coarse values each ``se::Node`` carries,
  node.hpp:44-87) become a dense mip pyramid: level ``l`` holds one value
  per octant of side ``8 * 2**l`` voxels, anchored at the octant's origin
  corner (the position the reference's update_node samples,
  projective_functor.hpp:113-137). ``mip_alloc[l]`` marks which octant
  values "exist" (i.e. their parent node is allocated in the reference),
  preserving observed/unseen semantics for collision queries and
  multi-scale occupancy.

Allocation is monotonic (slots are never freed within a session), which
makes the pool bump-allocated exactly like the reference's lock-free
``MemoryPool::acquire_block`` — but as a single vectorized prefix-sum
instead of per-thread atomics.
"""

import dataclasses
import math
from typing import Tuple, NamedTuple

import jax
import jax.numpy as jnp

from supereight_tpu.constants import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu.core import morton
from supereight_tpu.fields.base import FieldSpec


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """Static map geometry (jit-static; hashable).

    Mirrors the (size, dim) pair of ``Octree::init`` (octree.hpp:428-438).
    """

    size: int          # voxels per side (power of two, >= 16)
    dim: float         # metric extent of the cube (meters)
    capacity: int      # maximum number of allocated voxel blocks

    def __post_init__(self):
        assert self.size % BLOCK_SIDE == 0, "map size must be a multiple of 8"
        b = self.size // BLOCK_SIDE
        assert b & (b - 1) == 0, "block grid side must be a power of two"

    @property
    def voxel_size(self) -> float:
        return self.dim / self.size

    @property
    def inv_voxel_size(self) -> float:
        return self.size / self.dim

    @property
    def blocks_per_side(self) -> int:
        return self.size // BLOCK_SIDE

    @property
    def num_levels(self) -> int:
        """Mip levels: level 0 has blocks_per_side^3 octants, top has 1^3."""
        return int(math.log2(self.blocks_per_side)) + 1

    @property
    def max_depth(self) -> int:
        """Octree depth of a single voxel (log2 size), ref octree.hpp max_level_."""
        return int(math.log2(self.size))


class MapState(NamedTuple):
    """The dynamic map contents (a pytree; every leaf has a static shape)."""

    data_x: jnp.ndarray      # f32[capacity, 512] channel 0 (sdf / log-odds)
    data_y: jnp.ndarray      # f32[capacity, 512] channel 1 (weight / timestamp)
    block_coord: jnp.ndarray  # i32[capacity, 3] block-grid coordinate per slot
    active: jnp.ndarray      # bool[capacity] ref VoxelBlock::active_
    slot: jnp.ndarray        # i32[B, B, B] block coord -> slot (-1 = none)
    n_blocks: jnp.ndarray    # i32[] number of allocated slots
    # Dense internal-node storage; tuple index = level (0 = block-sized octants).
    mip_x: Tuple[jnp.ndarray, ...]      # f32[B>>l, B>>l, B>>l]
    mip_y: Tuple[jnp.ndarray, ...]
    mip_alloc: Tuple[jnp.ndarray, ...]  # bool[B>>l, ...] value exists


def make_map(geom: MapGeometry, field: FieldSpec) -> MapState:
    """Create an empty map (ref: Octree::init, octree.hpp:428-438)."""
    cap = geom.capacity
    b = geom.blocks_per_side
    init_x, init_y = field.init
    mips_x, mips_y, mips_a = [], [], []
    for lvl in range(geom.num_levels):
        s = b >> lvl
        mips_x.append(jnp.full((s, s, s), init_x, jnp.float32))
        mips_y.append(jnp.full((s, s, s), init_y, jnp.float32))
        mips_a.append(jnp.zeros((s, s, s), bool))
    return MapState(
        data_x=jnp.full((cap, BLOCK_VOXELS), init_x, jnp.float32),
        data_y=jnp.full((cap, BLOCK_VOXELS), init_y, jnp.float32),
        block_coord=jnp.zeros((cap, 3), jnp.int32),
        active=jnp.zeros((cap,), bool),
        slot=jnp.full((b, b, b), -1, jnp.int32),
        n_blocks=jnp.zeros((), jnp.int32),
        mip_x=tuple(mips_x),
        mip_y=tuple(mips_y),
        mip_alloc=tuple(mips_a),
    )


# ---------------------------------------------------------------------------
# Addressing helpers
# ---------------------------------------------------------------------------

def lookup_slot(state: MapState, bc: jnp.ndarray) -> jnp.ndarray:
    """Block coord [..., 3] -> pool slot (or -1). Replaces Octree::fetch.

    Out-of-range coordinates return -1.
    """
    b = state.slot.shape[0]
    inb = jnp.all((bc >= 0) & (bc < b), axis=-1)
    bcc = jnp.clip(bc, 0, b - 1)
    s = state.slot[bcc[..., 0], bcc[..., 1], bcc[..., 2]]
    return jnp.where(inb, s, -1)


def lookup_slot_c(state: MapState, bx, by, bz):
    """Component-wise :func:`lookup_slot` (coords must be in range).

    One flat 1-D gather; hot paths carry x/y/z as separate arrays to
    avoid padded [..., 3] stacks (see se3.py).
    """
    b = state.slot.shape[0]
    return state.slot.reshape(-1)[(bx * b + by) * b + bz]


def get_voxel_channel_c(geom: MapGeometry, state: MapState, field: FieldSpec,
                        vx, vy, vz, channel: int, fill: float = None):
    """Component-wise :func:`get_voxel_channel`: two flat gathers total."""
    if fill is None:
        fill = field.init[channel]
    size = geom.size
    inb = ((vx >= 0) & (vx < size) & (vy >= 0) & (vy < size)
           & (vz >= 0) & (vz < size))
    vxc = jnp.clip(vx, 0, size - 1)
    vyc = jnp.clip(vy, 0, size - 1)
    vzc = jnp.clip(vz, 0, size - 1)
    s = lookup_slot_c(state, vxc >> 3, vyc >> 3, vzc >> 3)
    ok = (s >= 0) & inb
    lin = (vxc & 7) + ((vyc & 7) << 3) + ((vzc & 7) << 6)
    flat = jnp.maximum(s, 0) * BLOCK_VOXELS + lin
    data = state.data_x if channel == 0 else state.data_y
    return jnp.where(ok, data.reshape(-1)[flat], fill)


def voxel_linear_index(local: jnp.ndarray) -> jnp.ndarray:
    """In-brick linear index, x-major like the reference (node.hpp:139-153)."""
    return (local[..., 0]
            + local[..., 1] * BLOCK_SIDE
            + local[..., 2] * BLOCK_SIDE * BLOCK_SIDE)


def get_voxel(geom: MapGeometry, state: MapState, field: FieldSpec,
              v: jnp.ndarray, fill: Tuple[float, float] = None):
    """Read voxels at integer coords ``v`` [..., 3].

    Unallocated or out-of-bounds voxels read as ``fill`` (default: the
    field's init value — matching ``Octree::get_fine``, octree.hpp:357-380).
    Returns (x, y) arrays of shape v.shape[:-1].
    """
    if fill is None:
        fill = field.init
    vv = jnp.clip(v, 0, geom.size - 1)
    inb = jnp.all((v >= 0) & (v < geom.size), axis=-1)
    bc = vv // BLOCK_SIDE
    local = vv % BLOCK_SIDE
    s = lookup_slot(state, bc)
    ok = (s >= 0) & inb
    sc = jnp.maximum(s, 0)
    lin = voxel_linear_index(local)
    flat = sc * BLOCK_VOXELS + lin
    x = jnp.where(ok, state.data_x.reshape(-1)[flat], fill[0])
    y = jnp.where(ok, state.data_y.reshape(-1)[flat], fill[1])
    return x, y


def get_voxel_channel(geom: MapGeometry, state: MapState, field: FieldSpec,
                      v: jnp.ndarray, channel: int, fill: float = None):
    """Single-channel variant of :func:`get_voxel`.

    The raycast interp path only reads one payload channel; gathering just
    it halves the HBM traffic of the hottest loop.
    """
    if fill is None:
        fill = field.init[channel]
    vv = jnp.clip(v, 0, geom.size - 1)
    inb = jnp.all((v >= 0) & (v < geom.size), axis=-1)
    bc = vv // BLOCK_SIDE
    local = vv % BLOCK_SIDE
    s = lookup_slot(state, bc)
    ok = (s >= 0) & inb
    flat = jnp.maximum(s, 0) * BLOCK_VOXELS + voxel_linear_index(local)
    data = state.data_x if channel == 0 else state.data_y
    return jnp.where(ok, data.reshape(-1)[flat], fill)


def get_with_coarse(geom: MapGeometry, state: MapState, field: FieldSpec,
                    v: jnp.ndarray):
    """Read voxels, falling back to the finest existing coarse value.

    Mirrors ``Octree::get(x,y,z)`` (octree.hpp:333-355): pointer descent
    stops at the first missing child and returns the parent's coarse value
    for that octant. Equivalently: the finest level l whose octant value
    exists (mip_alloc[l]); level -1 is the voxel itself.
    """
    x, y = get_voxel(geom, state, field, v)
    bc = jnp.clip(v // BLOCK_SIDE, 0, geom.blocks_per_side - 1)
    s = lookup_slot(state, v // BLOCK_SIDE)
    have = s >= 0
    # Walk mip levels from fine to coarse; take the first existing value.
    for lvl in range(geom.num_levels):
        g = bc >> lvl
        exists = state.mip_alloc[lvl][g[..., 0], g[..., 1], g[..., 2]]
        mx = state.mip_x[lvl][g[..., 0], g[..., 1], g[..., 2]]
        my = state.mip_y[lvl][g[..., 0], g[..., 1], g[..., 2]]
        take = exists & ~have
        x = jnp.where(take, mx, x)
        y = jnp.where(take, my, y)
        have = have | exists
    return x, y


def set_voxels(state: MapState, v: jnp.ndarray, x, y) -> MapState:
    """Scatter values into allocated voxels (unallocated writes are dropped).

    Mirrors ``Octree::set`` (octree.hpp:310-330) which silently ignores
    writes to unallocated space.
    """
    bc = v // BLOCK_SIDE
    s = lookup_slot(state, bc)
    lin = voxel_linear_index(v % BLOCK_SIDE)
    cap = state.data_x.shape[0]
    flat = jnp.where(s >= 0, s * BLOCK_VOXELS + lin, cap * BLOCK_VOXELS)
    dx = state.data_x.reshape(-1).at[flat].set(x, mode="drop")
    dy = state.data_y.reshape(-1).at[flat].set(y, mode="drop")
    return state._replace(
        data_x=dx.reshape(state.data_x.shape),
        data_y=dy.reshape(state.data_y.shape),
    )


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------

# per-frame bound on NEW block allocations (static shape for the top_k
# compaction below). Overflow cells stay unallocated and are re-touched
# on later frames while still observed.
ALLOC_BUDGET = 8192


def allocate_blocks(geom: MapGeometry, state: MapState,
                    touched: jnp.ndarray, with_stats: bool = False,
                    budget: int = None):
    """Allocate every block whose bit is set in the dense [B,B,B] mask.

    The reference funnels per-pixel candidate keys through an atomic list,
    sort, dedup and per-level insertion (octree.hpp:792-856). Here dedup is
    free (a dense boolean grid); new cells are compacted with one top_k
    (ascending cell id, matching the reference's sorted-key insertion
    order) so every scatter has only ALLOC_BUDGET updates: a scatter
    pays per UPDATE, so a 262k-update scatter was the old cost.
    Newly created blocks start active (ref: allocate_level sets
    active(true), octree.hpp:841).

    Also refreshes ``mip_alloc`` so coarse values exist for all 8 children
    of every allocated node, the set the reference's update_node walks.
    """
    b = geom.blocks_per_side
    cap = geom.capacity
    n_cells = b * b * b
    # ``budget`` (static) overrides ALLOC_BUDGET: noisy depth inflates
    # the per-frame touched set (band centers jitter by sigma(z) every
    # frame), and the reference allocates ALL candidates
    # (octree.hpp:792-817) — callers watching alloc_overflow grow the
    # bucket (one recompile per doubling, like integration_budget).
    kb = min(n_cells, ALLOC_BUDGET if budget is None else budget)
    flat_new = (touched & (state.slot < 0)).reshape(-1)
    g = jnp.arange(n_cells, dtype=jnp.int32)

    # top_k over (new ? 2*n_cells - cell : 0): selected new cells come out
    # in ascending cell-id order; zeros mark empty lanes.
    vals, _ = jax.lax.top_k(jnp.where(flat_new, 2 * n_cells - g, 0), kb)
    real = vals > n_cells
    cells = jnp.where(real, 2 * n_cells - vals, n_cells)
    dest = state.n_blocks + jnp.arange(kb, dtype=jnp.int32)
    ok = real & (dest < cap)
    dest_or_drop = jnp.where(ok, dest, cap)     # cap / n_cells -> dropped
    cells_or_drop = jnp.where(ok, cells, n_cells)

    cx = cells // (b * b)
    cy = (cells // b) % b
    cz = cells % b
    coords = jnp.stack([cx, cy, cz], axis=-1)

    block_coord = state.block_coord.at[dest_or_drop].set(coords, mode="drop")
    active = state.active.at[dest_or_drop].set(True, mode="drop")
    slot = state.slot.reshape(-1).at[cells_or_drop].set(
        dest, mode="drop").reshape(b, b, b)
    n_new = jnp.sum(ok.astype(jnp.int32))
    n_blocks = state.n_blocks + n_new

    # mark pre-existing touched blocks active too (ref: alloc_impl.hpp:109)
    # — gather-inverted: per slot, is my grid cell touched?
    tb = touched[jnp.clip(block_coord[:, 0], 0, b - 1),
                 jnp.clip(block_coord[:, 1], 0, b - 1),
                 jnp.clip(block_coord[:, 2], 0, b - 1)]
    slot_ids = jnp.arange(cap, dtype=jnp.int32)
    active = active | (tb & (slot_ids < n_blocks))

    state = state._replace(block_coord=block_coord, active=active,
                           slot=slot, n_blocks=n_blocks)
    state = refresh_mip_alloc(geom, state, slot >= 0)
    if with_stats:
        # candidates beyond ALLOC_BUDGET or pool capacity stay
        # unallocated this frame (re-touched later while observed); the
        # count makes the deviation from the reference's allocate-all
        # (octree.hpp:792-817) observable (ADVICE r2).
        overflow = jnp.sum(flat_new.astype(jnp.int32)) - n_new
        return state, {"alloc_overflow": overflow}
    return state


def refresh_mip_alloc(geom: MapGeometry, state: MapState,
                      block_alloc: jnp.ndarray,
                      extra_levels: Tuple[jnp.ndarray, ...] = None
                      ) -> MapState:
    """Recompute which coarse octant values exist.

    An octant's value lives in its parent node; the reference updates all 8
    child slots of every allocated node (projective_functor.hpp:113-137).
    So: parent-occupied = OR-reduce of child allocation, and existence at a
    level = parent-occupied broadcast back to all 8 siblings.

    ``extra_levels[l]`` optionally ORs in octants allocated *directly* at
    level l (OFusion's coarse free-space allocation, bfusion/alloc_impl).
    """
    nl = geom.num_levels

    def extra(lvl):
        if extra_levels is not None and lvl < len(extra_levels) \
                and extra_levels[lvl] is not None:
            return extra_levels[lvl]
        return None

    # occupied[l]: an octant at level l is allocated (as node or block) or
    # contains allocated descendants. The root (top level) always exists.
    occ = block_alloc
    if extra(0) is not None:
        occ = occ | extra(0)
    occupied = [occ]
    for lvl in range(1, nl):
        s = occ.shape[0] // 2
        occ = occ.reshape(s, 2, s, 2, s, 2).any(axis=(1, 3, 5))
        if extra(lvl) is not None:
            occ = occ | extra(lvl)
        occupied.append(occ)
    occupied[nl - 1] = jnp.ones_like(occupied[nl - 1])  # root node

    # A level-l octant's value slot exists iff its parent node (level l+1)
    # exists; the top-level octant is the root itself and has no slot.
    mips = []
    for lvl in range(nl - 1):
        parent = occupied[lvl + 1]
        mips.append(jnp.repeat(jnp.repeat(jnp.repeat(
            parent, 2, axis=0), 2, axis=1), 2, axis=2))
    mips.append(jnp.zeros_like(occupied[nl - 1]))
    # Allocation is monotonic: never lose an existing coarse slot.
    mips = [m | old for m, old in zip(mips, state.mip_alloc)]
    return state._replace(mip_alloc=tuple(mips))


def count_blocks(state: MapState) -> jnp.ndarray:
    """Number of allocated voxel blocks (ref: Octree::leavesCount)."""
    return state.n_blocks


def block_origin_voxel(state: MapState) -> jnp.ndarray:
    """Voxel coordinate of each slot's brick origin corner, i32[cap, 3]."""
    return state.block_coord * BLOCK_SIDE


def morton_keys(state: MapState) -> jnp.ndarray:
    """Morton key per slot (sort key for serialization / sharding)."""
    return morton.encode_v(state.block_coord)
