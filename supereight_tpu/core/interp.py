"""Trilinear interpolation and central-difference gradients over the block map.

Matches the reference's sampling semantics: field values are anchored at
integer voxel coordinates and interpolated between them
(ref: se_core/include/se/octree.hpp:542-563 ``interp``), with unallocated
stencil corners reading the field's ``empty()`` value
(ref: interp_gather.hpp:43-103) and gradient stencils reading ``init``
(ref: octree.hpp:652-737 ``grad`` which uses ``get``-with-init).

The reference specializes the 8-corner gather by which block faces the
stencil crosses (the crossmask switch, interp_gather.hpp:105-237) to save
pointer descents. With dense slot addressing every corner is an O(1)
gather, so no specialization is needed.

Shape discipline: the ``*_c`` forms carry x/y/z as separate arrays
and put the stencil dimension FIRST — tensors keep a large minor
dimension, and every fetch is one flat 1-D gather. Stacked-[..., 3]
wrappers are kept for the cold callers (volume facade, tests).
"""

import jax.numpy as jnp
import numpy as np

from supereight_tpu.core import map as m

# Corner offsets in the same order as interp_offsets (interp_gather.hpp:39-41).
_OFF = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
        (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]


def interp_c(geom, state, field, px, py, pz, channel=0):
    """Trilinear interpolation at continuous voxel coords (components).

    Matches Octree::interp (octree.hpp:542-563): base = floor(pos) clamped
    at 0, missing corners read empty().
    """
    bx = jnp.floor(px)
    by = jnp.floor(py)
    bz = jnp.floor(pz)
    fx, fy, fz = px - bx, py - by, pz - bz
    ix = jnp.maximum(bx.astype(jnp.int32), 0)
    iy = jnp.maximum(by.astype(jnp.int32), 0)
    iz = jnp.maximum(bz.astype(jnp.int32), 0)

    # corner dim leading: [8, ...]
    cx = ix[None] + jnp.asarray([o[0] for o in _OFF],
                                jnp.int32).reshape((8,) + (1,) * ix.ndim)
    cy = iy[None] + jnp.asarray([o[1] for o in _OFF],
                                jnp.int32).reshape((8,) + (1,) * iy.ndim)
    cz = iz[None] + jnp.asarray([o[2] for o in _OFF],
                                jnp.int32).reshape((8,) + (1,) * iz.ndim)
    p = m.get_voxel_channel_c(geom, state, field, cx, cy, cz, channel,
                              fill=field.empty[channel])
    c00 = p[0] * (1 - fx) + p[1] * fx
    c10 = p[2] * (1 - fx) + p[3] * fx
    c01 = p[4] * (1 - fx) + p[5] * fx
    c11 = p[6] * (1 - fx) + p[7] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def interp(geom, state, field, pos, channel=0):
    """Stacked-[..., 3] wrapper over :func:`interp_c`."""
    return interp_c(geom, state, field,
                    pos[..., 0], pos[..., 1], pos[..., 2], channel)


# The 4^3 gradient stencil (coordinates base-1 .. base+2 per axis) only
# ever samples points with at most ONE coordinate outside the central
# 2x2x2 core — 32 unique samples, fetched with a single batched gather.
# Per-axis coordinate index: 0 = base-1, 1 = base, 2 = base+1, 3 = base+2
# (each clamped to the map, octree.hpp:652-737).
_GRAD_SAMPLES = [(i, j, kk) for i in range(4) for j in range(4)
                 for kk in range(4)
                 if sum(1 for v in (i, j, kk) if v in (0, 3)) <= 1]
_GRAD_ID = {s: n for n, s in enumerate(_GRAD_SAMPLES)}
_GRAD_IX = np.asarray([s[0] for s in _GRAD_SAMPLES])
_GRAD_IY = np.asarray([s[1] for s in _GRAD_SAMPLES])
_GRAD_IZ = np.asarray([s[2] for s in _GRAD_SAMPLES])


def grad_c(geom, state, field, px, py, pz, channel=0):
    """Field gradient at continuous voxel coords (component form).

    Matches Octree::grad (octree.hpp:652-737): trilinearly-interpolated
    central differences with index clamping at the map boundary, scaled by
    0.5 * voxel_size (metric gradient of the raw field value). Missing
    samples read the field's init value. Returns (gx, gy, gz).
    """
    size = geom.size

    def ladder(b):
        # [4, ...] clamped coordinate ladder along one axis
        return jnp.stack([jnp.maximum(b - 1, 0),
                          jnp.maximum(b, 0),
                          jnp.minimum(b + 1, size - 1),
                          jnp.minimum(b + 2, size - 1)])

    bx = jnp.floor(px)
    by = jnp.floor(py)
    bz = jnp.floor(pz)
    fx, fy, fz = px - bx, py - by, pz - bz
    lx = ladder(bx.astype(jnp.int32))
    ly = ladder(by.astype(jnp.int32))
    lz = ladder(bz.astype(jnp.int32))

    vals = m.get_voxel_channel_c(geom, state, field,
                                 lx[_GRAD_IX], ly[_GRAD_IY], lz[_GRAD_IZ],
                                 channel, fill=field.init[channel])

    def p(i, j, kk):
        return vals[_GRAD_ID[(i, j, kk)]]

    # Axis 0 (x): difference along x at the 4 (y, z) corner combinations.
    def dx(jy, kz):
        return ((p(2, jy, kz) - p(0, jy, kz)) * (1 - fx)
                + (p(3, jy, kz) - p(1, jy, kz)) * fx)

    gx = ((dx(1, 1) * (1 - fy) + dx(2, 1) * fy) * (1 - fz)
          + (dx(1, 2) * (1 - fy) + dx(2, 2) * fy) * fz)

    def dy(ix, kz):
        return ((p(ix, 2, kz) - p(ix, 0, kz)) * (1 - fy)
                + (p(ix, 3, kz) - p(ix, 1, kz)) * fy)

    gy = ((dy(1, 1) * (1 - fx) + dy(2, 1) * fx) * (1 - fz)
          + (dy(1, 2) * (1 - fx) + dy(2, 2) * fx) * fz)

    def dz(ix, jy):
        return ((p(ix, jy, 2) - p(ix, jy, 0)) * (1 - fz)
                + (p(ix, jy, 3) - p(ix, jy, 1)) * fz)

    gz = ((dz(1, 1) * (1 - fx) + dz(2, 1) * fx) * (1 - fy)
          + (dz(1, 2) * (1 - fx) + dz(2, 2) * fx) * fy)

    s = 0.5 * geom.voxel_size
    return gx * s, gy * s, gz * s


def grad(geom, state, field, pos, channel=0):
    """Stacked-[..., 3] wrapper over :func:`grad_c`."""
    gx, gy, gz = grad_c(geom, state, field,
                        pos[..., 0], pos[..., 1], pos[..., 2], channel)
    return jnp.stack([gx, gy, gz], axis=-1)
