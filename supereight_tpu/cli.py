"""Headless benchmark front-end.

Behavioral reference: se_apps/src/benchmark.cpp — a frame loop with the
tab-separated per-stage timing log (benchmark.cpp:110-177) the reference's
Python harness parses, plus trajectory output for ATE evaluation.

Usage:
  python -m supereight_tpu.cli -i seq.raw -s 4.8 -p 0.34,0.5,0.24 ...
  python -m supereight_tpu.cli --synthetic 64        # no dataset needed

In-process callers use :func:`main`, which returns the run's summary.
"""

import sys
import time

import numpy as np

from supereight_tpu.config import build_parser, config_from_args
from supereight_tpu.io import dataset, synthetic
from supereight_tpu.pipeline import DenseSLAMSystem
from supereight_tpu.utils.perfstats import PerfStats, StatType

# budget counters: all zero in a well-sized run; nonzero means a static
# budget was too small for the scene and work was dropped
DROP_COUNTERS = ("alloc_overflow", "blocks_truncated", "patch_skipped",
                 "mip_skipped", "ray_overflow", "pool_bucket_overflow")

LOG_HEADER = ("frame\tacquisition\tpreprocessing\ttracking\tintegration\t"
              "raycasting\trendering\tcomputation\ttotal\tX\tY\tZ\t"
              "tracked\tintegrated")


def rotation_to_quaternion(R):
    """Shepperd's method: stable for every trace sign."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return x, y, z, w


def main(argv=None) -> dict:
    """Run the frame loop; returns the run's summary: ``frames``,
    ``fps``, per-frame ``frame_s`` (host clock, each frame ending in a
    device sync) and ``tracked`` flags, ``drops`` (the six drop counters
    summed over the run) and ``ate`` (ATE statistics when ground truth
    is known and tracking ran, else None)."""
    from supereight_tpu.utils import compilecache
    compilecache.enable()
    parser = build_parser()
    parser.add_argument("--synthetic", type=int, default=0,
                        help="run N synthetic frames instead of a dataset")
    parser.add_argument("--trajectory-out", type=str, default="",
                        help="write estimated trajectory (TUM format)")
    parser.add_argument("--groundtruth-mode", action="store_true",
                        help="bypass tracking, use ground-truth poses")
    parser.add_argument("--plot-out", type=str, default="",
                        help="write live perf/trajectory plots to this "
                             "PNG, refreshed every rendering_rate frames "
                             "(headless equivalent of the reference Qt "
                             "GUI stat plots, QtGUI.cpp:201-313)")
    parser.add_argument("--dump-renders", type=str, default="",
                        help="directory for 2x2 composite snapshots at "
                             "every render (viewer.composite_views)")
    parser.add_argument("--no-stage-sync", action="store_true",
                        help="skip the per-stage device syncs: stages "
                             "dispatch asynchronously and ONE batched "
                             "transfer ends the frame, so the per-stage "
                             "log columns show dispatch (not device) "
                             "time but the frame loop stops waiting on "
                             "the device after every stage; "
                             "`computation`/`total` and ATE stay correct")
    parser.add_argument("--serve", type=int, default=0, metavar="PORT",
                        help="serve a live interactive view on this HTTP "
                             "port: MJPEG stream of the 2x2 composite + "
                             "pause/resume/reset/view-toggle controls "
                             "(the pod equivalent of the reference Qt "
                             "GUI, QtGUI.cpp:84-258 / mainQt.cpp:201-313)")
    parser.add_argument("--keyframe-rate", type=int, default=0,
                        help="enable windowed pose-graph BA: a keyframe "
                             "every N frames (0 = off)")
    parser.add_argument("--ba-window", type=int, default=32)
    parser.add_argument("--ba-every", type=int, default=4,
                        help="optimize the window every N keyframes")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    gt_poses = None
    if args.synthetic:
        k = (120.0, 120.0, 80.0, 60.0)
        w, h = 160, 120
        cfg.camera = cfg.camera or k
        room = ((0.15, 0.15, 0.15),
                (cfg.volume_size - 0.15,) * 3)
        center = (cfg.volume_size / 2,) * 3
        # keep the sphere beyond the near plane and the walls inside far
        depths, gt_poses = synthetic.orbit_sequence(
            args.synthetic, cfg.camera, width=w, height=h,
            radius=0.4 * cfg.volume_size,
            center=center, sphere_radius=0.15 * cfg.volume_size,
            angle_span=0.6, room=room)
        frames = [(d, None) for d in depths]
        is_mm = False
        input_size = (w, h)
        init_pose = gt_poses[0]
    else:
        if not cfg.input_file:
            parser.error("need -i/--input-file or --synthetic N")
        reader = dataset.RawDepthReader(cfg.input_file,
                                        cfg.groundtruth_file)
        input_size = (reader.width, reader.height)
        cfg.camera = cfg.camera or reader.get_k()
        frames = None
        is_mm = True
        init_pose = None
        if reader.poses is not None:
            t = dataset.first_pose_transform(
                reader.poses[0],
                np.asarray(cfg.initial_pos_factor) * cfg.volume_size)
            gt_poses = [t @ p for p in reader.poses]
            init_pose = gt_poses[0]

    pipe = DenseSLAMSystem(input_size, cfg, init_pose=init_pose)
    if args.keyframe_rate:
        pipe.enable_keyframes(every=args.keyframe_rate,
                              window=args.ba_window,
                              ba_every=args.ba_every)
    live = None
    static_view_pose = None
    if args.serve:
        from supereight_tpu.webviewer import LiveViewer
        live = LiveViewer(args.serve)
        port = live.start()
        print(f"# live view: http://localhost:{port}/", file=sys.stderr)
    stats = PerfStats()
    out = sys.stdout
    log = open(cfg.log_file, "w") if cfg.log_file else out
    print(LOG_HEADER, file=log)

    est_traj = []
    raw_traj = []            # (frame, as-tracked pose) for post-BA output
    frame_s = []
    tracked_flags = []
    log_rows = []
    frame = 0
    t_start = time.perf_counter()
    while True:
        if args.max_frames is not None and frame >= args.max_frames:
            break
        if live is not None:
            # frame-pump controls (ref mainQt.cpp qtIdle loop + QtGUI
            # reset/pause): pause blocks acquisition; reset rebuilds the
            # pipeline (newDenseSLAMSystem, QtGUI.cpp:84) keeping the
            # input stream position
            while live.paused and not live.reset_pending:
                time.sleep(0.05)
            if live.take_reset():
                pipe = DenseSLAMSystem(input_size, cfg,
                                       init_pose=init_pose)
                if args.keyframe_rate:
                    pipe.enable_keyframes(every=args.keyframe_rate,
                                          window=args.ba_window,
                                          ba_every=args.ba_every)
                static_view_pose = None
        t0 = time.perf_counter()
        if frames is not None:
            if frame >= len(frames):
                break
            depth = frames[frame][0]
        else:
            depth, _, _ = reader.read_next()
            if depth is None:
                break
        t_acq = time.perf_counter()

        sync = not args.no_stage_sync
        pipe.preprocessing(depth, is_mm=is_mm)
        if sync:
            np.asarray(pipe.float_depth)  # sync
        t_pre = time.perf_counter()

        if args.groundtruth_mode and gt_poses is not None \
                and frame < len(gt_poses):
            pipe.set_pose(gt_poses[frame])
            tracked = True
        else:
            tracked = pipe.tracking(frame)
        if sync:
            np.asarray(pipe.pose)
        t_track = time.perf_counter()

        integrated = pipe.integration(frame) if (tracked or frame <= 3) \
            else False
        if sync:
            int(pipe.map.n_blocks)
        t_int = time.perf_counter()

        pipe.raycasting(frame)
        if sync:
            np.asarray(pipe.valid)
        # keyframe recording + windowed BA + loop closure (the pose-
        # graph layer; process_frame does this too — the CLI drives
        # stages individually and must call it itself, r5 fix: BA was
        # silently a no-op in every CLI run before)
        if pipe.keyframes is not None and tracked \
                and not args.groundtruth_mode and frame > 2:
            pipe._keyframe_step(frame)
        t_ray = time.perf_counter()

        # render views every rendering_rate frames (ref benchmark.cpp's
        # loop renders depth/track/volume each rendering_rate,
        # mainQt.cpp:201-313; timed into the `rendering` log column)
        if cfg.rendering_rate > 0 and frame % cfg.rendering_rate == 0 \
                and frame > 2:
            # model/camera view toggle (ref QtGUI setCameraView): static
            # mode pins the volume render to the pose captured at the
            # moment of the switch
            if live is not None and live.view_mode == "static":
                if static_view_pose is None:
                    static_view_pose = np.asarray(pipe.raycast_pose)
                vol = pipe.render_volume(view_pose=static_view_pose)
            else:
                static_view_pose = None
                vol = pipe.render_volume()
            views = {"depth": pipe.render_depth(),
                     "track": pipe.render_track(),
                     "volume": vol}
            if live is not None:
                from supereight_tpu import viewer as _viewer
                live.push(
                    _viewer.composite_views(views["depth"], views["track"],
                                            views["volume"]),
                    stats={"frame": frame,
                           "tracked": int(tracked),
                           "blocks": int(pipe.map.n_blocks),
                           **{kk: float(v)
                              for kk, v in pipe.stats.items()}})
            if args.dump_renders:
                import os
                from supereight_tpu import viewer
                os.makedirs(args.dump_renders, exist_ok=True)
                viewer.write_ppm(
                    os.path.join(args.dump_renders, f"frame{frame:05d}.ppm"),
                    viewer.composite_views(
                        views["depth"], views["track"], views["volume"]))
        t_render = time.perf_counter()

        # ONE batched device transfer for the frame's scalars (pose +
        # drop counters): fetching each separately costs a device-to-
        # host sync apiece
        import jax as _jax
        pose_np, stat_np = _jax.device_get((pipe.pose, dict(pipe.stats)))
        for name, v in stat_np.items():
            stats.sample(name, float(v), StatType.COUNT)

        pos = pose_np[:3, 3]
        row = (f"{frame}\t{t_acq - t0:.6f}\t{t_pre - t_acq:.6f}\t"
               f"{t_track - t_pre:.6f}\t{t_int - t_track:.6f}\t"
               f"{t_ray - t_int:.6f}\t{t_render - t_ray:.6f}\t"
               f"{t_ray - t_pre:.6f}\t{t_render - t0:.6f}\t"
               f"{pos[0]:.6f}\t{pos[1]:.6f}\t{pos[2]:.6f}\t"
               f"{int(tracked)}\t{int(integrated)}")
        print(row, file=log)
        log_rows.append({"frame": frame, "preprocessing": t_pre - t_acq,
                         "tracking": t_track - t_pre,
                         "integration": t_int - t_track,
                         "raycasting": t_ray - t_int,
                         "rendering": t_render - t_ray,
                         "computation": t_ray - t_pre,
                         "X": pos[0], "Y": pos[1], "Z": pos[2]})
        stats.sample("computation", t_ray - t_pre, StatType.TIME)
        if args.plot_out and cfg.rendering_rate > 0 \
                and frame % cfg.rendering_rate == 0 and frame > 2:
            from supereight_tpu import plots
            plots.plot_run(
                log_rows, args.plot_out,
                gt_xyz=None if gt_poses is None else
                np.asarray([p[:3, 3] for p in gt_poses[:frame + 1]]),
                est_xyz=np.asarray([r[1:4] for r in est_traj]))

        # BA corrections (identity when keyframes are off) apply to the
        # published trajectory
        P = pipe.trajectory_correction @ pose_np
        q = rotation_to_quaternion(P[:3, :3])
        est_traj.append((frame / 30.0, *P[:3, 3], *q))
        raw_traj.append((frame, pose_np))
        frame_s.append(time.perf_counter() - t0)
        tracked_flags.append(bool(tracked))
        frame += 1

    wall = time.perf_counter() - t_start
    fps = frame / wall if wall > 0 else 0.0
    print(f"# frames={frame} wall={wall:.2f}s fps={fps:.2f}", file=sys.stderr)
    drops = {n: int(stats.sum(n)) for n in DROP_COUNTERS
             if stats.has(n)}
    if drops:
        print("# drop counters (should be 0; nonzero = budgets too small "
              f"for this scene): {drops}", file=sys.stderr)

    if args.plot_out and log_rows:
        from supereight_tpu import plots
        plots.plot_run(
            log_rows, args.plot_out,
            gt_xyz=None if gt_poses is None else
            np.asarray([p[:3, 3] for p in gt_poses[:frame]]),
            est_xyz=np.asarray([r[1:4] for r in est_traj]))
        print(f"# stats plot: {args.plot_out}", file=sys.stderr)

    if pipe.keyframes is not None and raw_traj:
        # FINAL post-BA trajectory (what offline SLAM evaluation
        # scores): retro-apply each frame's nearest keyframe's BA
        # correction — the online stream above only carries corrections
        # forward from the moment they were computed
        corr = pipe.keyframes.frame_corrections()
        if corr:
            kf_frames = np.asarray([c[0] for c in corr])
            final = []
            for f, P0 in raw_traj:
                ki = int(np.argmin(np.abs(kf_frames - f)))
                P = corr[ki][1] @ P0
                q = rotation_to_quaternion(P[:3, :3])
                final.append((f / 30.0, *P[:3, 3], *q))
            est_traj = final

    if args.trajectory_out:
        with open(args.trajectory_out, "w") as f:
            for row in est_traj:
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")

    st = None
    if gt_poses is not None and not args.groundtruth_mode:
        from supereight_tpu.eval.ate import ate_statistics
        n = min(len(est_traj), len(gt_poses))
        est_xyz = np.asarray([r[1:4] for r in est_traj[:n]])
        gt_xyz = np.asarray([p[:3, 3] for p in gt_poses[:n]])
        st = ate_statistics(gt_xyz, est_xyz)
        print(f"# ATE RMSE {st['rmse']:.6f} m (mean {st['mean']:.6f}, "
              f"median {st['median']:.6f})", file=sys.stderr)

    if cfg.dump_volume_file:
        from supereight_tpu.io.serialise import save_map
        save_map(cfg.dump_volume_file, pipe.geom, pipe.map, pipe.field)

    if log is not out:
        log.close()
    return {"frames": frame, "fps": fps, "frame_s": frame_s,
            "tracked": tracked_flags,
            "drops": {n: int(stats.sum(n)) if stats.has(n) else 0
                      for n in DROP_COUNTERS},
            "ate": st}


if __name__ == "__main__":
    main()
