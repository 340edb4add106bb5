"""SE(3) utilities (exp map, inverse, camera matrices).

The reference leans on Sophus for ``SE3::exp`` (tracking.cpp:310) and
Eigen for 4x4 algebra; here they are a handful of jnp ops. Twist layout
matches Sophus: x = [translation(3), rotation(3)].
"""

import jax
import jax.numpy as jnp

# Pose algebra is tiny (3x3..6x6) but accuracy-critical: force true f32
# matmuls. At default precision a GPU may run f32 products in TF32
# (~3 decimal digits). Throughput is irrelevant at these shapes;
# tracking accuracy is not.
_HIGHEST = jax.lax.Precision.HIGHEST


def _einsum(spec, *args):
    return jnp.einsum(spec, *args, precision=_HIGHEST)


def hat(w):
    """Skew-symmetric matrix of w[..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1),
    ], -2)


def exp(twist):
    """SE(3) exponential map; twist [..., 6] -> [..., 4, 4] matrix.

    Uses the Taylor expansion below 1e-8 rad^2 so it is jit-safe at
    the identity (where ICP converges).
    """
    v, w = twist[..., :3], twist[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < 1e-8

    # guarded values (avoid 0/0 under jit)
    th = jnp.where(small, 1.0, theta)
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - theta_sq / 24.0,
                  (1.0 - jnp.cos(th)) / (th * th))
    c = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                  (th - jnp.sin(th)) / (th * th * th))

    W = hat(w)
    W2 = jnp.matmul(W, W, precision=_HIGHEST)
    eye = jnp.broadcast_to(jnp.eye(3), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = _einsum("...ij,...j->...i", V, v)

    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0, 1.0]),
                              top.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def inverse(T):
    """Inverse of a rigid transform [..., 4, 4]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -_einsum("...ij,...j->...i", Rt, t)
    top = jnp.concatenate([Rt, ti[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0, 1.0]),
                              top.shape[:-2] + (1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def transform(T, p):
    """Apply [..., 4, 4] to points [..., 3] (homogeneous w=1)."""
    return _einsum("ij,...j->...i", T[:3, :3], p) + T[:3, 3]


def rotate(T, p):
    """Apply only the rotation part of T to [..., 3]."""
    return _einsum("ij,...j->...i", T[:3, :3], p)


# ---------------------------------------------------------------------------
# Component-wise forms for hot per-pixel/per-voxel paths.
#
# Bulk math on [..., 3]-stacked point clouds runs on a tiny minor
# dimension (strided loads, padded tiles, tiny einsums). The hot pipeline
# stages therefore carry x/y/z as three separate full-size arrays and
# apply transforms as unrolled scalar-broadcast multiply-adds — exact f32
# elementwise math (the accuracy HIGHEST buys for the einsum path) that
# XLA fuses into its neighbours.
# ---------------------------------------------------------------------------

def transform_c(T, x, y, z):
    """Apply a 4x4 rigid/projective-affine transform to component arrays.

    Returns (x', y', z') with the same shapes; equivalent to
    :func:`transform` on stacked points.
    """
    return (T[0, 0] * x + T[0, 1] * y + T[0, 2] * z + T[0, 3],
            T[1, 0] * x + T[1, 1] * y + T[1, 2] * z + T[1, 3],
            T[2, 0] * x + T[2, 1] * y + T[2, 2] * z + T[2, 3])


def rotate_c(T, x, y, z):
    """Rotation-only component-wise form of :func:`rotate`."""
    return (T[0, 0] * x + T[0, 1] * y + T[0, 2] * z,
            T[1, 0] * x + T[1, 1] * y + T[1, 2] * z,
            T[2, 0] * x + T[2, 1] * y + T[2, 2] * z)


def camera_matrix(k):
    """4x4 intrinsics from k = (fx, fy, cx, cy) (ref commons.h:255-262)."""
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    K = jnp.zeros((4, 4)).at[0, 0].set(fx).at[0, 2].set(cx) \
        .at[1, 1].set(fy).at[1, 2].set(cy).at[2, 2].set(1.0).at[3, 3].set(1.0)
    return K


def inverse_camera_matrix(k):
    """Inverse intrinsics (ref commons.h:264-270)."""
    fx, fy, cx, cy = k[0], k[1], k[2], k[3]
    K = jnp.zeros((4, 4)).at[0, 0].set(1.0 / fx).at[0, 2].set(-cx / fx) \
        .at[1, 1].set(1.0 / fy).at[1, 2].set(-cy / fy) \
        .at[2, 2].set(1.0).at[3, 3].set(1.0)
    return K
