"""ATE lever probe: run the loop scene through the fused frame_step at
the traj2 config (640x480 c=2 -> 320x240, 512^3, 4.8 m) and print
per-frame pose error + final ICP ATE. For iterating on tracking
accuracy levers before the official CLI eval (tools/run_longseq_eval).

Usage: python tools/ate_probe.py --frames 100 [--mu 0.1]
       [--iterations 10,5,4] [--icp-threshold 1e-5] [--noise 0]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from supereight_tpu.utils import compilecache  # noqa: E402
compilecache.enable()

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--mu", type=float, default=0.1)
    ap.add_argument("--field", default="tsdf")
    ap.add_argument("--iterations", default="10,5,4")
    ap.add_argument("--icp-threshold", type=float, default=1e-5)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--filter", default="",
                    help="input filter: bilateral | median")
    ap.add_argument("--noise-weighted", action="store_true")
    ap.add_argument("--budget", type=int, default=0,
                    help="fixed integration budget (0 = adaptive "
                         "doubling; fixed avoids mid-run recompiles)")
    ap.add_argument("--alloc-budget", type=int, default=0,
                    help="fixed allocation budget (0 = adaptive)")
    ap.add_argument("--capacity", type=int, default=36864)
    ap.add_argument("--print-every", type=int, default=10)
    ap.add_argument("--integration-rate", type=int, default=1)
    ap.add_argument("--min-ref-weight", type=float, default=0)
    ap.add_argument("--fuse-filtered", action="store_true")
    ap.add_argument("--traj-out", default="",
                    help="save est+gt positions to this .npz")
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from supereight_tpu.core.map import MapGeometry
    from supereight_tpu.eval.ate import ate_statistics
    from supereight_tpu.fields import get_field
    from supereight_tpu.io import synthetic
    from supereight_tpu.parallel import step as pstep

    W, H = 320, 240
    DIM = 4.8
    geom = MapGeometry(size=args.size, dim=DIM, capacity=args.capacity)
    field = get_field(args.field)
    k = (240.6, 240.0, 160.0, 120.0)
    iters = tuple(int(x) for x in args.iterations.split(","))

    print(f"generating {args.frames}-frame loop ({W}x{H})...",
          file=sys.stderr)
    depths, poses = synthetic.loop_sequence(
        args.frames, k, width=W, height=H, dim=DIM,
        noise_factor=args.noise)

    state = pstep.init_frame_state(geom, field, (W, H), poses[0])
    kj = jnp.asarray(k, jnp.float32)
    budget = args.budget or 8192
    alloc_budget = args.alloc_budget or 8192
    filt = args.filter if args.filter else False
    t0 = time.perf_counter()
    errs, est = [], []
    tracked_n = 0
    drops = {"alloc_overflow": 0, "blocks_truncated": 0,
             "patch_skipped": 0, "ray_overflow": 0,
             "pool_bucket_overflow": 0}
    nb = 0
    for i in range(args.frames):
        if not args.budget:
            budget = max(budget, pstep.integration_budget(geom, nb + 2048))
        fn = functools.partial(
            pstep.frame_step, geom, field, frame_size=(W, H),
            iterations=iters, mu=args.mu,
            icp_threshold=args.icp_threshold, neg_y=False,
            filter_input=filt, use_gt_pose=False,
            integration_rate=args.integration_rate,
            min_ref_weight=args.min_ref_weight,
            fuse_filtered=args.fuse_filtered,
            tracking_rate=1, budget=budget, alloc_budget=alloc_budget,
            noise_weighted=args.noise_weighted)
        state, aux = fn(state, jnp.asarray(depths[i]), kj, jnp.int32(i))
        # ONE host transfer per frame: every scalar fetched separately
        # costs a device-to-host sync of its own
        P, aux = jax.device_get((state.pose, aux))
        nb = int(aux["n_blocks"])
        est.append(P[:3, 3])
        err = np.linalg.norm(P[:3, 3] - poses[i][:3, 3])
        errs.append(err)
        tracked_n += int(aux["tracked"])
        for key in drops:
            drops[key] += int(aux.get(key, 0))
        # self-sizing allocation bucket (mirrors pipeline.integration)
        if not args.alloc_budget and int(aux.get("alloc_overflow", 0)) > 0:
            alloc_budget = min(2 * alloc_budget,
                               geom.blocks_per_side ** 3)
        if i % args.print_every == 0 or i == args.frames - 1:
            red = np.asarray(aux.get("reduction"))
            rms = float(np.sqrt(red[0] / max(red[28], 1.0)))
            print(f"  f{i:4d} err={err:.4f} m blocks={nb} "
                  f"trk={int(aux['tracked'])} inl={int(red[28])} "
                  f"rms={rms:.4f} rayovf={int(aux.get('ray_overflow', 0))}",
                  file=sys.stderr)
    wall = time.perf_counter() - t0

    gt_xyz = np.asarray([p[:3, 3] for p in poses])
    if args.traj_out:
        np.savez(args.traj_out, est=np.asarray(est), gt=gt_xyz,
                 gt_poses=np.asarray(poses))
    st = ate_statistics(gt_xyz, np.asarray(est))
    print(f"frames={args.frames} wall={wall:.1f}s "
          f"tracked={tracked_n}/{args.frames} drops={drops}",
          file=sys.stderr)
    print(f"ATE RMSE {st['rmse']:.4f} m (mean {st['mean']:.4f}, "
          f"median {st['median']:.4f}, max {max(errs):.4f})")


if __name__ == "__main__":
    main()
