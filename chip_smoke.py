"""Smoke test of the SLAM frame on one GPU, through the user's entry points.

Runs the reference's canonical traj2 configuration (640x480 input, `-c 2`
so 320x240 compute, a 4.8 m volume at 512^3, ICP on) on the first 60
frames of the 250-frame synthetic loop scene, in one process:

1. device check: JAX's first device is a GPU, else exit non-zero;
2. served path: ``supereight_tpu.cli.main`` on the .raw sequence, TSDF
   then OFusion; ATE, the six drop counters and the tracked fraction are
   checked;
3. fused step: ``parallel.step.frame_step`` on the same frames (ATE,
   drops, memory), then compared frame by frame with the stage-wise
   ``DenseSLAMSystem`` (the plain reference): each frame starts from the
   reference's pose and raycast of the frame before, and the pose and
   the raycast of the step's own map that it hands on must match the
   reference's.

``--four`` instead runs only the sharded step (``parallel.dist_step``,
frustum halo) on four GPUs and compares it frame by frame with the
single-card ``frame_step`` the same way.

The last line of stdout is a JSON object,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed. Any failed check raises.

Usage: python chip_smoke.py [--four]
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, ".smoke_data")   # listed in .gitignore
INIT_POS = (0.5, 0.4583, 0.18)   # -p: start position, fraction of volume

# Fused step vs stage-wise reference (and sharded vs single card), per
# frame from the same start: what the reference handed on after the
# frame before (pose and raycast). Each side then tracks, integrates
# into its own map and raycasts that map; the two outputs are compared.
# Pose: both run the same f32 math with pose products at HIGHEST, but
# XLA fuses and orders the ICP sums differently in one program than in
# per-stage programs (and across devices when sharded), so the poses
# differ by rounding: 5 mm and 0.1 deg are about half a voxel (9.4 mm)
# and far below what a tracking fault moves (centimetres).
MAX_DT_M = 0.005
MAX_DR_DEG = 0.1
# Raycast, i.e. the map as the next frame's ICP sees it: the share of
# pixels hit by one and missed by the other, and over pixels hit by
# both the 99th percentile of the vertex distance along the reference's
# normal (ICP's own point-to-plane residual: it sees one surface moved,
# not a hit point slid along it by a pose within the limit above) and
# of the normal angle. The percentile leaves out rays that graze a
# silhouette or an edge. Sound runs on the H100 read at most 0.07 %,
# 0.34 mm and 2.5 deg (sharded vs single; fused vs stage-wise 0.0013 %,
# 0.05 mm, 0.53 deg); a fault in one side's integration read 91-160 mm
# and 120 deg (PERF.md). 2 mm is a fifth of a voxel; 5 deg leaves room
# for edge normals, which turn ~6 deg per mm of slide.
MAX_HIT_FLIP = 0.01
MAX_PLANE_P99_M = 0.002
MAX_NORMAL_P99_DEG = 5.0
TRACK_FIELDS = ("pose", "raycast_pose", "vertex", "normal", "valid")


@dataclasses.dataclass(frozen=True)
class Config:
    """One smoke configuration; the defaults are the full-size run."""
    width: int = 640            # input frame
    height: int = 480
    ratio: int = 2              # the reference's -c
    voxels: int = 512
    dim: float = 4.8
    frames: int = 60            # frames run ...
    loop_frames: int = 250      # ... of a loop this long
    pyramid: tuple = (10, 5, 4)
    preset_budget: int = 36864
    local_capacity: int = 12288  # per device, --four only
    # ATE over the 60 frames (PERF.md): TSDF read 0.0155-0.0159 m on
    # the CPU (fused and stage-wise) and 0.0143-0.0148 m fused on the
    # H100. The H100's stage-wise run reads 0.0211 m: at frame 42 its
    # ICP lands 22 mm further off, from the raycast of a map built along
    # a path 2.3 mm from the fused run's (from that same start the fused
    # step lands there too, within 0.06 mm). Frames 37-45 amplify small
    # differences; the CPU's two paths part by 4 mm there. A lost track
    # costs far more: the camera moves 1.5 m.
    ate_bound_m: float = 0.03

    def camera(self):
        """traj2 intrinsics at the input size (fy > 0: the synthetic
        scene is y-down)."""
        s = self.width / 640.0
        return (481.2 * s, 480.0 * s, self.width / 2.0, self.height / 2.0)

    def cli_argv(self, raw, gt, field):
        argv = ["-i", raw, "-g", gt,
                "-s", str(self.dim), "-p", ",".join(map(str, INIT_POS)),
                "-z", "4",
                "-c", str(self.ratio), "-r", "1", "-t", "1",
                "-v", str(self.voxels),
                "-k", ",".join(str(v) for v in self.camera()),
                "-y", ",".join(str(v) for v in self.pyramid),
                "--max-frames", str(self.frames), "--no-stage-sync",
                "--preset-budget", str(self.preset_budget)]
        if field == "tsdf":
            return argv + ["-f", "tsdf", "-m", "0.1"]
        return argv + ["-f", "ofusion", "-m", "0.008", "-z", "0"]


class CompileMeter:
    """Seconds JAX spent compiling (or loading from the persistent
    cache) and persistent-cache hits, since construction."""

    def __init__(self):
        import jax
        self.seconds = 0.0
        self.programs = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
            self.programs += 1

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self):
        return (self.seconds, self.programs, self.cache_hits)

    def since(self, snap):
        s, p, h = snap
        return (f"{self.seconds - s:.1f} s compiling {self.programs - p} "
                f"programs ({self.cache_hits - h} persistent-cache hits)")


def device_check():
    """Refuses anything but a GPU; prints what the run is on."""
    from supereight_tpu.utils import compilecache, device
    dev = device.require_gpu()
    print(f"device: {dev['kind']} x{dev['count']} ({dev['platform']})")
    for line in device.card_lines():
        print(line)
    print(f"compile cache: {compilecache.enable()}")
    return dev


def make_data(cfg, data_dir=DATA_DIR):
    """The seeded loop-scene .raw + ground truth; written once."""
    from supereight_tpu.io.convert import synthetic2raw
    os.makedirs(data_dir, exist_ok=True)
    raw = os.path.join(data_dir, f"loop{cfg.frames}of{cfg.loop_frames}_"
                                 f"{cfg.width}x{cfg.height}.raw")
    if not (os.path.exists(raw) and os.path.exists(raw + ".gt.txt")):
        t0 = time.perf_counter()
        synthetic2raw(raw, cfg.frames, scene="loop",
                      loop_frames=cfg.loop_frames,
                      size=(cfg.width, cfg.height))
        print(f"data: wrote {raw} in {time.perf_counter() - t0:.1f} s")
    return raw, raw + ".gt.txt"


def served_phase(cfg, field, raw, gt, meter, card=""):
    """The CLI, in process, on the .raw sequence; returns its summary."""
    from supereight_tpu import cli
    snap = meter.snapshot()
    s = cli.main(cfg.cli_argv(raw, gt, field))
    if s["frames"] != cfg.frames:
        raise AssertionError(f"{field}: ran {s['frames']} frames")
    if any(s["drops"].values()):
        raise AssertionError(f"{field}: drop counters {s['drops']}")
    # frames 0-3 cannot track: the first raycast, the reference ICP
    # needs, runs at frame 3 (the reference's bootstrap, kept as is)
    tracked = float(np.mean(s["tracked"][4:]))
    if tracked < 0.95:
        raise AssertionError(f"{field}: tracked fraction {tracked:.3f} "
                             f"< 0.95 over frames 4+")
    ate = s["ate"]["rmse"]      # NaN for a non-finite trajectory
    if not ate < cfg.ate_bound_m:
        raise AssertionError(f"{field}: ATE RMSE {ate:.4f} m >= "
                             f"{cfg.ate_bound_m} m")
    steady = s["frame_s"][len(s["frame_s"]) // 2:]
    print(f"served {field} on {card}: ATE RMSE {ate:.6f} m, drops "
          f"{s['drops']}, tracked {tracked:.3f} of frames 4+, "
          f"{meter.since(snap)}, wall {s['fps']:.2f} fps over "
          f"{s['frames']} frames incl. compile, steady "
          f"{len(steady) / sum(steady):.2f} fps over the last "
          f"{len(steady)}")
    return s


def _frames_and_gt(cfg, raw, gt):
    """Depth frames in metres at compute size, intrinsics at compute
    size and the ground-truth poses, exactly as the CLI derives them."""
    import jax.numpy as jnp
    from supereight_tpu.io import dataset
    from supereight_tpu.ops import preprocess
    reader = dataset.RawDepthReader(raw, gt)
    cw, ch = cfg.width // cfg.ratio, cfg.height // cfg.ratio
    depths = [preprocess.mm2meters(jnp.asarray(reader.read_frame(i)[0]),
                                   (ch, cw)) for i in range(cfg.frames)]
    t = dataset.first_pose_transform(
        reader.poses[0], np.asarray(INIT_POS) * cfg.dim)
    k = jnp.asarray(cfg.camera(), jnp.float32) / cfg.ratio
    gts = np.asarray([t @ p for p in reader.poses[:cfg.frames]])
    return depths, k, (cw, ch), gts


def _pose_gaps(a, b):
    """Per-frame translation (m) and rotation (deg) differences.

    The angle comes from ||Ra - Rb||_F = 2 sqrt(2) sin(theta / 2), which
    stays exact for small angles; arccos of the trace would turn the f32
    rounding of two equal rotations into ~0.1 deg."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=-1)
    f = np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2))
    return dt, np.degrees(2.0 * np.arcsin(np.minimum(f / np.sqrt(8.0), 1)))


def _raycast_gaps(a, b):
    """How far raycast ``a`` is from ``b`` (dicts of vertex, normal and
    valid maps): (share of pixels hit by one and missed by the other,
    and over pixels hit by both the 99th percentile of the vertex
    distance along b's normal in m and of the normal angle in deg)."""
    flip = float(np.mean(a["valid"] != b["valid"]))
    both = a["valid"] & b["valid"]
    if not both.any():
        return flip, 0.0, 0.0
    nb = b["normal"][both].astype(np.float64)
    d = np.abs(np.sum((a["vertex"][both] - b["vertex"][both]) * nb, -1))
    c = np.linalg.norm(a["normal"][both] - nb, axis=-1)
    ang = np.degrees(2.0 * np.arcsin(np.minimum(c / 2.0, 1.0)))
    return flip, float(np.percentile(d, 99)), float(np.percentile(ang, 99))


def _check_runs(name, got, ref):
    """Holds two runs' per-frame outputs (see _outputs) to the pose and
    raycast limits; prints the largest reading of each."""
    dt, dr = _pose_gaps([o["pose"] for o in got], [o["pose"] for o in ref])
    rc = np.asarray([_raycast_gaps(a, b) for a, b in zip(got, ref)])
    cols = {"translation mm": (dt * 1e3, MAX_DT_M * 1e3),
            "rotation deg": (dr, MAX_DR_DEG),
            "hit/miss flips %": (rc[:, 0] * 100, MAX_HIT_FLIP * 100),
            "point-to-plane p99 mm": (rc[:, 1] * 1e3,
                                      MAX_PLANE_P99_M * 1e3),
            "normal p99 deg": (rc[:, 2], MAX_NORMAL_P99_DEG)}
    print(f"{name}, largest per frame: " + ", ".join(
        f"{c} {v.max():.4f} (frame {int(v.argmax())}, limit {lim:g})"
        for c, (v, lim) in cols.items()))
    bad = {c: np.nonzero(v > lim)[0].tolist()
           for c, (v, lim) in cols.items() if (v > lim).any()}
    if bad:
        raise AssertionError(f"{name}: beyond the limit on frames {bad}")


def _outputs(state):
    """Host copies of what a frame hands the next: the pose and the
    raycast. ``state`` is a FrameState, a DistState or a
    DenseSLAMSystem, which name these fields alike."""
    return {n: np.array(getattr(state, n)) for n in TRACK_FIELDS}


def _fused_kwargs(cfg, geom, frame_size):
    from supereight_tpu.parallel import step as pstep
    return dict(frame_size=frame_size, iterations=cfg.pyramid, mu=0.1,
                icp_threshold=1e-5, neg_y=False, filter_input=False,
                use_gt_pose=False, integration_rate=1, tracking_rate=1,
                budget=pstep.integration_budget(geom, cfg.preset_budget))


def _run_fused(cfg, geom, depths, k, frame_size, pose0, forced=None):
    """frame_step over the frames. With ``forced`` (another run's
    per-frame outputs), frame i > 0 starts from forced[i - 1] instead of
    the step's own pose and raycast, on the step's own map. Returns
    (per-frame outputs, host seconds per frame, last state, summed drop
    counters)."""
    import jax
    import jax.numpy as jnp
    from supereight_tpu.cli import DROP_COUNTERS
    from supereight_tpu.fields import get_field
    from supereight_tpu.parallel import step as pstep
    field = get_field("tsdf")
    kw = _fused_kwargs(cfg, geom, frame_size)
    state = pstep.init_frame_state(geom, field, frame_size, pose0)
    outs, frame_s, drops = [], [], dict.fromkeys(DROP_COUNTERS, 0)
    for i, d in enumerate(depths):
        if forced is not None and i > 0:
            state = state._replace(**{n: jnp.asarray(v)
                                      for n, v in forced[i - 1].items()})
        t0 = time.perf_counter()
        state, aux = pstep.frame_step(geom, field, state, d, k,
                                      jnp.int32(i), **kw)
        a = jax.device_get(aux)
        frame_s.append(time.perf_counter() - t0)
        outs.append(_outputs(state))
        for n in DROP_COUNTERS:
            drops[n] += int(a[n])
    return outs, frame_s, state, drops


def _run_stagewise(cfg, raw, gt, pose0):
    """DenseSLAMSystem, configured by the served TSDF run's own flags;
    returns its per-frame outputs."""
    from supereight_tpu.config import build_parser, config_from_args
    from supereight_tpu.io import dataset
    from supereight_tpu.pipeline import DenseSLAMSystem
    args, _ = build_parser().parse_known_args(cfg.cli_argv(raw, gt, "tsdf"))
    pipe = DenseSLAMSystem((cfg.width, cfg.height), config_from_args(args),
                           init_pose=pose0)
    reader = dataset.RawDepthReader(raw)
    outs = []
    for i in range(cfg.frames):
        pipe.process_frame(reader.read_frame(i)[0], i, is_mm=True)
        outs.append(_outputs(pipe))
    return outs


def _ate(outs, gts):
    from supereight_tpu.eval.ate import ate_statistics
    poses = np.asarray([o["pose"] for o in outs])
    return ate_statistics(gts[:, :3, 3], poses[:, :3, 3])["rmse"]


def _free_gap_note(name, a, b):
    """One line on how far two free trajectories drift apart; for the
    record, not a check (ill-conditioned frames amplify rounding)."""
    dt, _ = _pose_gaps([o["pose"] for o in a], [o["pose"] for o in b])
    over = np.nonzero(dt > MAX_DT_M)[0]
    print(f"{name}, free runs (not checked): largest gap "
          f"{dt.max() * 1e3:.4f} mm (frame {int(dt.argmax())}), first frame "
          f"beyond {MAX_DT_M * 1e3:g} mm: "
          f"{int(over[0]) if over.size else None}")


def fused_phase(cfg, raw, gt, meter):
    """frame_step on its own trajectory (ATE, drops), then frame by frame
    against the stage-wise DenseSLAMSystem from the same start.

    Per frame from a shared start, not as two free trajectories: on
    this loop a sub-millimetre difference between two free runs grows to
    ~20 mm within a few frames around frames 38-42 (measured on the
    H100; PERF.md), so free trajectories would measure the scene's
    conditioning, not whether the two implementations agree. The
    raycast comparison holds each side's own map to the reference's.
    """
    import jax
    import jax.numpy as jnp
    from supereight_tpu.config import Configuration
    from supereight_tpu.core.map import MapGeometry
    from supereight_tpu.fields import get_field
    from supereight_tpu.parallel import step as pstep
    depths, k, frame_size, gts = _frames_and_gt(cfg, raw, gt)
    # the served run's pool size
    capacity = Configuration(volume_resolution=cfg.voxels).resolve_capacity()
    geom = MapGeometry(size=cfg.voxels, dim=cfg.dim, capacity=capacity)
    snap = meter.snapshot()
    free, frame_s, state, drops = _run_fused(cfg, geom, depths, k,
                                             frame_size, gts[0])
    if not all(np.isfinite(o["pose"]).all() for o in free) \
            or any(drops.values()):
        raise AssertionError(f"fused: non-finite poses or drops {drops}")
    ate = _ate(free, gts)
    steady = frame_s[len(frame_s) // 2:]
    print(f"fused frame_step: ATE RMSE {ate:.6f} m, drops {drops}, "
          f"{meter.since(snap)}, {len(depths)} frames in {sum(frame_s):.2f} "
          f"s incl. compile, steady {len(steady) / sum(steady):.2f} fps "
          f"over the last {len(steady)} (host clock, pose and counters "
          f"fetched each frame)")
    if not ate < cfg.ate_bound_m:
        raise AssertionError(f"fused: ATE RMSE {ate:.4f} m >= "
                             f"{cfg.ate_bound_m} m")
    lowered = pstep.frame_step.lower(
        geom, get_field("tsdf"), state, depths[0], k, jnp.int32(0),
        **_fused_kwargs(cfg, geom, frame_size))
    print(f"frame_step memory_analysis: "
          f"{lowered.compile().memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    ref = _run_stagewise(cfg, raw, gt, gts[0])
    _free_gap_note("fused vs stage-wise", free, ref)
    got, _, _, drops = _run_fused(cfg, geom, depths, k, frame_size, gts[0],
                                  forced=ref)
    if any(drops.values()):
        raise AssertionError(f"fused (forced): drops {drops}")
    _check_runs("fused vs stage-wise, each frame from the same start",
                got, ref)


def four_phase(cfg, raw, gt, meter, n_dev=4):
    """Sharded step (frustum halo) on n_dev devices vs the single-card
    frame_step, each frame from the single card's outputs of the frame
    before (see fused_phase for why); the state must spread over every
    device."""
    import jax
    import jax.numpy as jnp
    from supereight_tpu.core.map import MapGeometry
    from supereight_tpu.fields import get_field
    from supereight_tpu.parallel import dist_step
    if len(jax.devices()) < n_dev:
        raise AssertionError(f"--four needs {n_dev} devices, JAX found "
                             f"{len(jax.devices())}")
    depths, k, frame_size, gts = _frames_and_gt(cfg, raw, gt)
    geom = MapGeometry(size=cfg.voxels, dim=cfg.dim,
                       capacity=n_dev * cfg.local_capacity)
    single, _, _, drops = _run_fused(cfg, geom, depths, k, frame_size,
                                     gts[0])
    if any(drops.values()):
        raise AssertionError(f"single-card drops {drops}")
    print(f"single card: ATE RMSE {_ate(single, gts):.6f} m")

    geom_l = MapGeometry(size=cfg.voxels, dim=cfg.dim,
                         capacity=cfg.local_capacity)
    mesh = dist_step.make_mesh(n_dev)
    step = dist_step.make_dist_step(
        mesh, geom_l, get_field("tsdf"), frame_size=frame_size,
        iterations=cfg.pyramid, mu=0.1, icp_threshold=1e-5,
        frustum_halo=True)
    state = dist_step.init_dist_state(mesh, geom_l, get_field("tsdf"),
                                      frame_size, gts[0])
    sh = dist_step.dist_state_shardings(mesh, state)
    snap = meter.snapshot()
    t0 = time.perf_counter()
    outs, per_dev = [], None
    for i, d in enumerate(depths):
        if i > 0:
            state = state._replace(**{n: jax.device_put(v, getattr(sh, n))
                                      for n, v in single[i - 1].items()})
        state, aux = step(state, d, k, jnp.int32(i))
        a = jax.device_get(aux)
        outs.append(_outputs(state))
        per_dev = a["n_blocks_dev"]
        for n in ("alloc_overflow", "blocks_truncated", "halo_overflow"):
            if int(a[n]):
                raise AssertionError(f"dist frame {i}: {n} = {int(a[n])}")
    print(f"dist step on {n_dev} devices: {meter.since(snap)}, "
          f"{len(depths)} frames in {time.perf_counter() - t0:.2f} s incl. "
          f"compile, blocks per device {per_dev.tolist()}")
    placed = {s.device for s in state.map.data_x.addressable_shards}
    if len(placed) != n_dev or not (per_dev > 0).all():
        raise AssertionError(f"state not spread over {n_dev} devices: on "
                             f"{sorted(str(p) for p in placed)}, blocks "
                             f"{per_dev.tolist()}")
    _check_runs(f"dist ({n_dev} devices) vs single, each frame from the "
                f"same start", outs, single)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-GPU sharded step vs single-card "
                         "frame_step")
    args = ap.parse_args(argv)
    dev = device_check()
    meter = CompileMeter()
    cfg = Config()
    raw, gt = make_data(cfg)
    if args.four:
        four_phase(cfg, raw, gt, meter)
    else:
        from supereight_tpu.utils import device
        card = "; ".join(device.card_lines())
        served_phase(cfg, "tsdf", raw, gt, meter, card)
        served_phase(cfg, "ofusion", raw, gt, meter, card)
        fused_phase(cfg, raw, gt, meter)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))


if __name__ == "__main__":
    main()
