"""Occupancy (OFusion) field plugin: Bayesian log-odds fusion.

Behavioral reference: voxel_traits<OFusion> (volume_traits.hpp:59-72), the
bspline sensor model and update functor
(se_denseslam/src/bfusion/mapping_impl.hpp:94-191) and the constant-step
raycast (bfusion/rendering_impl.hpp:35-68).
Payload: x = log-odds occupancy clamped to +/-1000, y = last update time.

The reference memoizes the bspline CDF in a generated lookup table
(bspline_lookup.cc); on the device the closed form is a handful of
elementwise ops, so we
evaluate it directly — bitwise-identical to the exact (non-memoized)
``bspline`` (mapping_impl.hpp:94-106) rather than the quantized LUT.
"""

import jax.numpy as jnp

from supereight_tpu.constants import (BOTTOM_CLAMP, CAPITAL_T, SURF_BOUNDARY,
                                      TOP_CLAMP)
from supereight_tpu.fields.base import FieldSpec

OFUSION = FieldSpec(
    name="ofusion",
    init=(0.0, 0.0),
    empty=(0.0, 0.0),
    multiscale_alloc=True,
    invert_normals=False,
)


def bspline(t):
    """Integral of the B-spline sensor kernel (ref mapping_impl.hpp:94-106)."""
    v1 = (3.0 + t) ** 3 / 48.0
    v2 = 0.5 + (t * (3.0 + t) * (3.0 - t)) / 24.0
    v3 = 1.0 - (3.0 - t) ** 3 / 48.0
    out = jnp.where((t >= -3.0) & (t <= -1.0), v1, 0.0)
    out = jnp.where((t > -1.0) & (t <= 1.0), v2, out)
    out = jnp.where((t > 1.0) & (t <= 3.0), v3, out)
    out = jnp.where(t > 3.0, 1.0, out)
    return out


def H(val):
    """Piecewise occupancy probability along the ray (ref H, 108-112)."""
    return bspline(val) - 0.5 * bspline(val - 3.0)


def update_logs(prior, sample):
    """Accumulate log2-odds (ref updateLogs, 145-148)."""
    return prior + jnp.log2(sample / (1.0 - sample))


def apply_window(occupancy, delta_t, tau=CAPITAL_T):
    """Temporal decay of stale occupancy (ref applyWindow, 150-155)."""
    fraction = 1.0 / (1.0 + delta_t / tau)
    return occupancy * jnp.maximum(0.5, fraction)


def update(old_x, old_y, pos_cam, depth_sample, noise_factor, timestamp,
           voxel_size, valid):
    """Fuse one observation into occupancy voxels (ref bfusion_update, 157-191).

    ``noise_factor`` is the pipeline's mu for the OFusion field;
    ``depth_sample`` should already be the bilinearly filtered depth
    (ref interpDepth, mapping_impl.hpp:41-92). ``pos_cam`` is an
    (x, y, z) tuple of camera-frame component arrays.
    Returns (new_x, new_y, wrote).
    """
    px, py_, pz = pos_cam
    ray_scale = jnp.sqrt(1.0 + (px / pz) ** 2 + (py_ / pz) ** 2)
    diff = (pz - depth_sample) * ray_scale
    sigma = jnp.clip(noise_factor * pz * pz, 2.0 * voxel_size, 0.05)
    sample = H(diff / sigma)
    write = valid & (depth_sample > 0) & (sample != 0.5)
    sample = jnp.clip(sample, 0.03, 0.97)
    delta_t = timestamp - old_y
    decayed = apply_window(old_x, delta_t)
    new_x = jnp.clip(update_logs(decayed, sample), BOTTOM_CLAMP, TOP_CLAMP)
    return (jnp.where(write, new_x, old_x),
            jnp.where(write, timestamp, old_y),
            write)


def interp_depth(depth, proj):
    """Bilinear depth filtering in inverse-depth space (ref interpDepth, 41-92).

    depth: [H, W]; proj: [..., 2] continuous pixel coords. Falls back to the
    nearest sample when neighbours disagree by > 5 cm or any is missing.
    """
    h, w = depth.shape
    x1 = jnp.floor(proj[..., 0])
    y1 = jnp.floor(proj[..., 1] + 1.0)
    x2 = jnp.floor(proj[..., 0] + 1.0)
    y2 = jnp.floor(proj[..., 1])

    def at(px, py):
        xi = jnp.clip(px.astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(py.astype(jnp.int32), 0, h - 1)
        return depth[yi, xi]

    d11 = at(x1, y1)
    d12 = at(x1, y2)
    d21 = at(x2, y1)
    d22 = at(x2, y2)
    any_zero = (d11 == 0) | (d12 == 0) | (d21 == 0) | (d22 == 0)
    safe = lambda d: jnp.where(d == 0, 1.0, d)
    f = (1.0 / safe(d11) * (x2 - proj[..., 0]) * (y2 - proj[..., 1])
         + 1.0 / safe(d21) * (proj[..., 0] - x1) * (y2 - proj[..., 1])
         + 1.0 / safe(d12) * (x2 - proj[..., 0]) * (proj[..., 1] - y1)
         + 1.0 / safe(d22) * (proj[..., 0] - x1) * (proj[..., 1] - y1))
    denom = (x2 - x1) * (y2 - y1)
    d = 1.0 / (f / denom)
    thresh = 0.05
    consistent = ((jnp.abs(d - d11) < thresh) & (jnp.abs(d - d12) < thresh)
                  & (jnp.abs(d - d21) < thresh) & (jnp.abs(d - d22) < thresh))
    nearest = at(jnp.floor(proj[..., 0] + 0.5), jnp.floor(proj[..., 1] + 0.5))
    out = jnp.where(consistent, d, nearest)
    return jnp.where(any_zero, 0.0, out)
