"""TSDF (KinectFusion-style signed distance) field plugin.

Behavioral reference: voxel_traits<SDF> (volume_traits.hpp:41-51), the
fusion functor sdf_update (se_denseslam/src/kfusion/mapping_impl.hpp:35-65)
and the sphere-traced raycast (kfusion/rendering_impl.hpp:34-74).
Payload: x = signed distance clamped to [-1, 1] (in units of mu),
y = integer fusion weight capped at MAX_WEIGHT.
"""

import jax.numpy as jnp

from supereight_tpu.constants import MAX_WEIGHT
from supereight_tpu.fields.base import FieldSpec

TSDF = FieldSpec(
    name="tsdf",
    init=(1.0, 0.0),
    empty=(1.0, -1.0),
    multiscale_alloc=False,
    invert_normals=True,
)


# range-weighting anchor: samples at z <= Z0 carry full weight, beyond
# it the weight falls as (Z0/z)^2 ~ 1/sigma(z) of the z^2 sensor noise
# model (floored at 1/16 so far surfaces still integrate)
NOISE_WEIGHT_Z0 = 1.5


def update(old_x, old_y, pos_cam, depth_sample, mu, valid,
           noise_weighted: bool = False):
    """Fuse one depth observation into TSDF voxels (ref sdf_update, 35-65).

    pos_cam: voxel position in the camera frame — a (x, y, z) tuple of
    component arrays (shape discipline, se3.transform_c).
    Returns (new_x, new_y, wrote) with the running weighted mean of the
    truncated SDF along the pixel ray; non-writes pass old values through.

    ``noise_weighted`` (static): weight each sample by
    clamp((Z0/z)^2, 1/16, 1) instead of the reference's constant 1
    (sdf_update weighs every sample equally, mapping_impl.hpp:50-57) —
    with sigma(z) ~ z^2 range noise, far samples carry ~1/sigma weight
    so they stop dragging near-range geometry (the noise-grade fusion
    option; off = exact reference behavior).
    """
    px, py_, pz = pos_cam
    # distance along the ray to the voxel's depth plane, scaled to ray length
    ray_scale = jnp.sqrt(1.0 + (px / pz) ** 2 + (py_ / pz) ** 2)
    diff = (depth_sample - pz) * ray_scale
    write = valid & (depth_sample > 0) & (diff > -mu)
    sdf = jnp.minimum(1.0, diff / mu)
    if noise_weighted:
        w = jnp.clip((NOISE_WEIGHT_Z0 / jnp.maximum(pz, 1e-3)) ** 2,
                     1.0 / 16.0, 1.0)
    else:
        w = 1.0
    new_x = jnp.clip((old_y * old_x + w * sdf) / (old_y + w), -1.0, 1.0)
    new_y = jnp.minimum(old_y + w, MAX_WEIGHT)
    return (jnp.where(write, new_x, old_x),
            jnp.where(write, new_y, old_y),
            write)
