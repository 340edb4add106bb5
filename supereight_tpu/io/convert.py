"""Dataset conversion tools (the se_tools layer).

Behavioral reference: se_tools/scene2raw.cpp (ICL-NUIM scene -> .raw) and
se_tools/oni2raw.cpp (OpenNI recording -> .raw; OpenNI hardware SDKs are
not installed here, so that path raises with guidance).

Usage:
  python -m supereight_tpu.io.convert scene2raw <scene_dir> <out.raw>
  python -m supereight_tpu.io.convert synthetic <out.raw> --frames 64
"""

import argparse
import sys

import numpy as np


def scene2raw(scene_dir: str, out_path: str) -> int:
    """Prefers the native converter; falls back to the Python reader."""
    from supereight_tpu.io import native
    if native.available():
        return native.scene2raw(scene_dir, out_path)
    from supereight_tpu.io import dataset
    reader = dataset.SceneDepthReader(scene_dir)
    depths = []
    while True:
        d = reader.read_next()
        if d is None:
            break
        depths.append((d * 1000.0).astype(np.uint16))
    if depths:
        dataset.write_raw(out_path, np.stack(depths))
    return len(depths)


def oni2raw(*_args, **_kw):
    raise NotImplementedError(
        "oni2raw needs the OpenNI SDK and a live/recorded camera; convert "
        "the .oni on a workstation with the reference tool and feed the "
        ".raw here (the format is identical).")


def synthetic2raw(out_path: str, frames: int = 64, scene: str = "orbit",
                  noise_factor: float = 0.0, loop_frames: int = None,
                  size=(640, 480)):
    """Render a synthetic scene into a .raw sequence + TUM gt file.

    scene="orbit": the simple sphere-in-a-room test scene.
    scene="loop": the traj2-class benchmark — multi-object room
    (occlusions, pillar, table, spheres), full closed-loop trajectory,
    optional Kinect-model depth noise (synthetic.loop_sequence).
    ``loop_frames`` > ``frames`` writes only the first ``frames`` frames
    of a ``loop_frames``-frame loop (its per-frame motion, fewer frames).
    ``size`` is (width, height); the intrinsics are the traj2 camera
    (481.2, 480, 320, 240) scaled to it.
    """
    from supereight_tpu.io import dataset, synthetic
    w, h = size
    k = (481.2 * w / 640.0, 480.0 * h / 480.0, w / 2.0, h / 2.0)
    dim = 4.8
    if scene == "loop":
        depths, poses = synthetic.loop_sequence(
            loop_frames or frames, k, width=w, height=h, dim=dim,
            noise_factor=noise_factor, n_render=frames)
    else:
        depths, poses = synthetic.orbit_sequence(
            frames, k, width=w, height=h, radius=0.3 * dim,
            center=(dim / 2,) * 3, sphere_radius=0.15 * dim,
            angle_span=0.6, room=((0.55,) * 3, (dim - 0.55,) * 3))
    dataset.write_raw(out_path, np.round(depths * 1000.0).astype(np.uint16))
    gt_path = out_path + ".gt.txt"
    from supereight_tpu.cli import rotation_to_quaternion
    with open(gt_path, "w") as f:
        for i, p in enumerate(poses):
            q = rotation_to_quaternion(p[:3, :3])
            f.write(f"{i/30.0:.6f} {p[0,3]:.6f} {p[1,3]:.6f} {p[2,3]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(prog="supereight-tpu-convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("scene2raw")
    s1.add_argument("scene_dir")
    s1.add_argument("out")
    s2 = sub.add_parser("synthetic")
    s2.add_argument("out")
    s2.add_argument("--frames", type=int, default=64)
    s2.add_argument("--scene", choices=["orbit", "loop"], default="orbit")
    s2.add_argument("--noise-factor", type=float, default=0.0)
    args = p.parse_args(argv)
    if args.cmd == "scene2raw":
        n = scene2raw(args.scene_dir, args.out)
    else:
        n = synthetic2raw(args.out, args.frames, scene=args.scene,
                          noise_factor=args.noise_factor)
    print(f"wrote {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
