"""Synthetic depth-sequence generator for tests and benchmarks.

The reference has no synthetic data path (its unit tests use analytic
fields, its end-to-end tests use ICL-NUIM downloads). A closed-form
scene (sphere + walls rendered by exact ray intersection) lets this repo
gate the full pipeline — allocation, fusion, ICP, raycast — without any
dataset, on CPU or GPU, with exact ground-truth poses and depth.
"""

import numpy as np


def _ray_grid(width, height, k):
    fx, fy, cx, cy = k
    xs = (np.arange(width) - cx) / fx
    ys = (np.arange(height) - cy) / fy
    dx, dy = np.meshgrid(xs, ys, indexing="xy")
    d = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
    return d


def render_depth(pose, k, width=320, height=240,
                 sphere_center=(0.0, 0.0, 0.0), sphere_radius=0.5,
                 box_min=None, box_max=None, max_depth=4.0):
    """Exact depth render of a sphere inside an axis-aligned room.

    pose: camera-to-world 4x4. Returns f32 [H, W] depth (z-depth, meters),
    0 where no hit.
    """
    rays_cam = _ray_grid(width, height, k)
    R, t = pose[:3, :3], pose[:3, 3]
    rays = rays_cam @ R.T
    norm = np.linalg.norm(rays, axis=-1)
    dirs = rays / norm[..., None]
    origin = t

    t_hit = np.full((height, width), np.inf)

    # sphere
    oc = origin - np.asarray(sphere_center)
    b = np.sum(dirs * oc, axis=-1)
    c = np.dot(oc, oc) - sphere_radius ** 2
    disc = b * b - c
    mask = disc >= 0
    th = -b - np.sqrt(np.maximum(disc, 0.0))
    t_hit = np.where(mask & (th > 0), np.minimum(t_hit, th), t_hit)

    # room interior walls
    if box_min is not None:
        box_min = np.asarray(box_min, np.float64)
        box_max = np.asarray(box_max, np.float64)
        safe = np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
        for axis in range(3):
            for bound in (box_min[axis], box_max[axis]):
                tw = (bound - origin[axis]) / safe[..., axis]
                p = origin + tw[..., None] * dirs
                others = [a for a in range(3) if a != axis]
                inside = np.ones_like(tw, bool)
                for a in others:
                    inside &= (p[..., a] >= box_min[a] - 1e-9) \
                        & (p[..., a] <= box_max[a] + 1e-9)
                ok = inside & (tw > 0)
                t_hit = np.where(ok, np.minimum(t_hit, tw), t_hit)

    # ray length -> z-depth: the camera-frame ray has z == 1 before
    # normalization, so the hit's camera z is t_hit / |rays_cam|.
    zdepth = np.where(np.isfinite(t_hit), t_hit / norm, 0.0)
    if max_depth is not None:
        # a real depth camera reports 0 beyond its range
        zdepth = np.where(zdepth > max_depth, 0.0, zdepth)
    return zdepth.astype(np.float32)


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Camera-to-world pose with +z looking from eye toward target.

    Uses the depth-camera convention (x right, y down, z forward), so
    ``up`` is negated into the y axis.
    """
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    upv = -np.asarray(up, np.float64)
    right = np.cross(upv, fwd)
    if np.linalg.norm(right) < 1e-9:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T.astype(np.float32)


def render_depth_scene(pose, k, width, height, spheres=(), boxes=(),
                       room=None, max_depth=4.0):
    """Exact depth render of a multi-object scene: solid spheres, solid
    axis-aligned boxes (hit from outside — slab entry), and room walls
    (hit from inside). The traj2-class eval scene uses this to get
    occlusions and depth discontinuities the single-sphere scene lacks.
    """
    rays_cam = _ray_grid(width, height, k)
    R, t = pose[:3, :3], pose[:3, 3]
    rays = rays_cam @ R.T
    norm = np.linalg.norm(rays, axis=-1)
    dirs = rays / norm[..., None]
    origin = t

    t_hit = np.full((height, width), np.inf)

    for c, r in spheres:
        oc = origin - np.asarray(c, np.float64)
        b = np.sum(dirs * oc, axis=-1)
        cc = np.dot(oc, oc) - r ** 2
        disc = b * b - cc
        mask = disc >= 0
        th = -b - np.sqrt(np.maximum(disc, 0.0))
        t_hit = np.where(mask & (th > 0), np.minimum(t_hit, th), t_hit)

    safe = np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    for bmin, bmax in boxes:
        bmin = np.asarray(bmin, np.float64)
        bmax = np.asarray(bmax, np.float64)
        t0 = (bmin - origin) / safe
        t1 = (bmax - origin) / safe
        tn = np.minimum(t0, t1).max(axis=-1)
        tf = np.maximum(t0, t1).min(axis=-1)
        ok = (tn < tf) & (tn > 0)
        t_hit = np.where(ok, np.minimum(t_hit, tn), t_hit)

    if room is not None:
        box_min = np.asarray(room[0], np.float64)
        box_max = np.asarray(room[1], np.float64)
        for axis in range(3):
            for bound in (box_min[axis], box_max[axis]):
                tw = (bound - origin[axis]) / safe[..., axis]
                p = origin + tw[..., None] * dirs
                others = [a for a in range(3) if a != axis]
                inside = np.ones_like(tw, bool)
                for a in others:
                    inside &= (p[..., a] >= box_min[a] - 1e-9) \
                        & (p[..., a] <= box_max[a] + 1e-9)
                ok = inside & (tw > 0)
                t_hit = np.where(ok, np.minimum(t_hit, tw), t_hit)

    zdepth = np.where(np.isfinite(t_hit), t_hit / norm, 0.0)
    if max_depth is not None:
        zdepth = np.where(zdepth > max_depth, 0.0, zdepth)
    return zdepth.astype(np.float32)


def default_loop_scene(dim=4.8):
    """The traj2-class eval scene: a room with a central pillar, a
    table-like slab, a wall-mounted box and three spheres — occlusions,
    thin structure, varied depth ranges."""
    c = dim / 2
    spheres = [((c - 0.9, c - 0.45, c + 0.7), 0.42),
               ((c + 1.05, c + 0.55, c - 0.65), 0.3),
               ((c + 0.55, c - 0.85, c - 1.05), 0.22)]
    boxes = [
        # central pillar, floor to ceiling
        ((c - 0.22, 0.55, c - 0.22), (c + 0.22, dim - 0.55, c + 0.22)),
        # table slab
        ((c - 1.5, c + 0.28, c - 1.15), (c - 0.45, c + 0.45, c - 0.45)),
        # box against the +x wall
        ((dim - 1.15, c - 0.5, c + 0.35), (dim - 0.62, c + 0.5, c + 1.15)),
    ]
    room = ((0.55, 0.55, 0.55), (dim - 0.55,) * 3)
    return spheres, boxes, room


def add_depth_noise(depth, noise_factor, seed=0):
    """Kinect-style range noise: sigma = noise_factor * z^2 (the same
    model the OFusion update assumes, bfusion/mapping_impl.hpp:168-170),
    plus millimeter quantization. 0 stays 0 (missing)."""
    rng = np.random.RandomState(seed)
    sigma = noise_factor * depth * depth
    noisy = depth + rng.standard_normal(depth.shape).astype(np.float32) \
        * sigma
    noisy = np.round(noisy * 1000.0) / 1000.0
    return np.where(depth > 0, np.maximum(noisy, 0.0), 0.0) \
        .astype(np.float32)


def loop_sequence(n_frames, k, width=640, height=480, dim=4.8,
                  radius=None, max_depth=4.0, noise_factor=0.0, seed=0,
                  scene=None, n_render=None):
    """Closed-loop trajectory through the multi-object room: the camera
    travels a full circle (ending where it started — a loop closure) at
    varying height, looking inward-ahead, so every wall and object is
    seen, occluded and re-seen. The traj2-class benchmark path.

    ``n_render`` (default ``n_frames``) renders only that prefix of the
    ``n_frames``-frame loop: the same per-frame motion, fewer frames.

    Returns (depths [N,H,W] f32 meters, poses [N,4,4]), N = n_render.
    """
    c = dim / 2
    if radius is None:
        radius = 0.32 * dim
    spheres, boxes, room = scene if scene is not None \
        else default_loop_scene(dim)
    depths, poses = [], []
    ease = min(20, n_frames // 8)
    total = 2.0 * np.pi
    for i in range(n_frames if n_render is None else n_render):
        u = i / max(n_frames - 1, 1)
        # quadratic ease-in over the first `ease` frames (bootstrap
        # window), then constant angular speed, closing the full loop
        ue = ease / max(n_frames - 1, 1)
        if u < ue and ue > 0:
            s = 0.5 * u * u / ue
        else:
            s = u - 0.5 * ue
        ang = total * s / (1.0 - 0.5 * ue)
        eye = (c + radius * np.sin(ang),
               c + 0.12 * np.sin(2.0 * ang) - 0.2,
               c - radius * np.cos(ang))
        look_ang = ang + 0.55
        target = (c + 0.25 * radius * np.sin(look_ang),
                  c - 0.1,
                  c - 0.25 * radius * np.cos(look_ang))
        pose = look_at(eye, target)
        d = render_depth_scene(pose, k, width, height, spheres=spheres,
                               boxes=boxes, room=room,
                               max_depth=max_depth)
        if noise_factor > 0:
            d = add_depth_noise(d, noise_factor, seed=seed + i)
        depths.append(d)
        poses.append(pose)
    return np.stack(depths), np.stack(poses)


def orbit_sequence(n_frames, k, width=320, height=240, radius=1.6,
                   center=(1.0, 1.0, 1.0), sphere_radius=0.5,
                   angle_span=0.8, room=None, max_depth=4.0):
    """Orbiting-camera sequence around a sphere at ``center``.

    Returns (depths [N,H,W] f32 meters, poses [N,4,4] camera-to-world).
    """
    depths, poses = [], []
    for i in range(n_frames):
        # quadratic ease-in: the first frames are nearly static, matching
        # how real sequences start and giving the pipeline its bootstrap
        # window (raycast maps only exist from frame 3)
        u = i / max(n_frames - 1, 1)
        ang = angle_span * u * u
        eye = (center[0] + radius * np.sin(ang),
               center[1] + 0.1 * np.sin(2 * ang),
               center[2] - radius * np.cos(ang))
        pose = look_at(eye, center)
        if room is None:
            box_min = box_max = None
        else:
            box_min, box_max = room
        d = render_depth(pose, k, width, height, sphere_center=center,
                         sphere_radius=sphere_radius,
                         box_min=box_min, box_max=box_max,
                         max_depth=max_depth)
        depths.append(d)
        poses.append(pose)
    return np.stack(depths), np.stack(poses)
