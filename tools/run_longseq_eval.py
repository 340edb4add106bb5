"""The traj2-class long-sequence evaluation.

Generates the multi-object closed-loop synthetic benchmark at the
reference's canonical traj2 configuration (640x480 input, -c 2, 4.8 m
volume, 512^3 voxels), runs it END TO END through the real harness
(`python -m supereight_tpu.cli` + eval.ate), in ICP mode, for TSDF and
OFusion — optionally with pose-graph BA and sensor noise — and prints a
markdown results table (checked into EVAL.md).

Each variant is a CLI child process that opens the GPU itself, one at a
time; this parent imports nothing that touches JAX, so it never holds
the card (a second JAX process on a card fails for want of memory).

Mirrors the reference's out-of-repo pipeline:
se_apps/scripts/_run.py:76-153 (spawn binary, parse log, score ATE) and
run_kf.py:33-50 (config sweep).

Usage:  python tools/run_longseq_eval.py [--frames 250] [--out EVAL.md]
"""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def run_one(raw, gt, extra, log_file, max_frames):
    cmd = [sys.executable, "-m", "supereight_tpu.cli",
           "-i", raw, "-g", gt, "-o", log_file,
           "-s", "4.8", "-p", "0.5,0.4583,0.18", "-z", "4", "-c", "2",
           "-r", "1", "-t", "1", "-v", "512",
           "-k", "481.2,480,320,240", "-y", "10,5,4",
           "--max-frames", str(max_frames), "--no-stage-sync",
           "--preset-budget", "36864"] + extra
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    ate = None
    fps = None
    drops = ""
    tracked_frac = None
    for line in proc.stderr.splitlines():
        if "ATE RMSE" in line:
            ate = float(line.split("ATE RMSE")[1].split()[0])
        if line.startswith("# frames=") and "fps=" in line:
            fps = float(line.split("fps=")[1])
        if "drop counters" in line:
            drops = line.split(":", 1)[1].strip()
    try:
        from supereight_tpu.eval.sweep import parse_frame_log, summarize
        s = summarize(parse_frame_log(log_file))
        tracked_frac = s.get("tracked_fraction")
        comp_fps = s.get("fps")
    except Exception:
        comp_fps = None
    return {"rc": proc.returncode, "ate": ate, "fps": fps,
            "comp_fps": comp_fps, "tracked": tracked_frac,
            "drops": drops, "stderr": proc.stderr[-2000:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--out", default="")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="extra noisy-depth variant with this factor")
    ap.add_argument("--variant", default="",
                    help="run only this variant (exact name, or 'noise') — lets "
                         "each run fit a background time slot; results "
                         "accumulate as JSON in --workdir and --out "
                         "renders every variant seen so far")
    args = ap.parse_args()

    wd = args.workdir or tempfile.mkdtemp(prefix="longseq_")
    os.makedirs(wd, exist_ok=True)
    raw = os.path.join(wd, "loop.raw")
    gt = raw + ".gt.txt"
    if not os.path.exists(raw):
        print(f"generating {args.frames}-frame loop sequence...",
              file=sys.stderr)
        from supereight_tpu.io.convert import synthetic2raw
        synthetic2raw(raw, args.frames, scene="loop")

    variants = [
        ("tsdf icp", ["-f", "tsdf", "-m", "0.1"]),
        ("ofusion icp", ["-f", "ofusion", "-m", "0.008", "-z", "0"]),
        ("tsdf icp+BA", ["-f", "tsdf", "-m", "0.1",
                         "--keyframe-rate", "15"]),
    ]
    import json
    results_dir = os.path.join(wd, "results")
    os.makedirs(results_dir, exist_ok=True)
    for name, extra in variants:
        if args.variant and args.variant != name:
            continue
        log = os.path.join(wd, name.replace(" ", "_").replace("+", "_")
                           + ".log")
        print(f"running {name}...", file=sys.stderr)
        r = run_one(raw, gt, extra, log, args.frames)
        print(f"  -> rc={r['rc']} ate={r['ate']} fps={r['fps']} "
              f"drops={r['drops']}", file=sys.stderr)
        if r["rc"] != 0:
            print(r["stderr"], file=sys.stderr)
        with open(os.path.join(results_dir,
                               name.replace(" ", "_") + ".json"),
                  "w") as f:
            json.dump({"name": name, **{k: v for k, v in r.items()
                                        if k != "stderr"}}, f)

    if args.noise > 0 and (not args.variant
                           or args.variant.startswith("tsdf icp noise")
                           or args.variant == "noise"):
        raw_n = os.path.join(wd, "loop_noisy.raw")
        if not os.path.exists(raw_n):
            from supereight_tpu.io.convert import synthetic2raw
            synthetic2raw(raw_n, args.frames, scene="loop",
                          noise_factor=args.noise)
        noise_variants = [
            (f"tsdf icp noise={args.noise}",
             ["-f", "tsdf", "-m", "0.1"]),
            # the r5 noise-grade stack (EVAL noise note): iterated
            # median input filter fused into the map, map-maturity ICP
            # gate, sigma(z)-weighted fusion, pool sized for the
            # noise-inflated surface band
            (f"tsdf icp noise={args.noise}+levers",
             ["-f", "tsdf", "-m", "0.1", "--filter", "median2",
              "--fuse-filtered", "--min-ref-weight", "4",
              "--noise-weighted", "--block-capacity", "49152",
              "--preset-budget", "49152"]),
            # the BA-pays-its-way row: partial levers leave a drift
            # regime (~0.2 m offset slide); loop closure + windowed BA
            # recovers it in the final trajectory (r5)
            (f"tsdf icp noise={args.noise}+BA",
             ["-f", "tsdf", "-m", "0.1", "--filter", "median",
              "--fuse-filtered", "--keyframe-rate", "15", "-z", "0"]),
            (f"tsdf icp noise={args.noise} partial-levers (BA baseline)",
             ["-f", "tsdf", "-m", "0.1", "--filter", "median",
              "--fuse-filtered", "-z", "0"]),
        ]
        for name, extra in noise_variants:
            if args.variant and args.variant not in ("noise", name):
                continue
            log = os.path.join(wd, name.replace(" ", "_").replace("+", "_")
                               + ".log")
            r = run_one(raw_n, raw_n + ".gt.txt", extra, log, args.frames)
            print(f"  -> {name} rc={r['rc']} ate={r['ate']}",
                  file=sys.stderr)
            with open(os.path.join(results_dir,
                                   name.replace(" ", "_") + ".json"),
                      "w") as f:
                json.dump({"name": name, **{k: v for k, v in r.items()
                                            if k != "stderr"}}, f)

    # render every result recorded in the workdir so far
    rows = []
    for fn in sorted(os.listdir(results_dir)):
        with open(os.path.join(results_dir, fn)) as f:
            rr = json.load(f)
        rows.append((rr.pop("name"), rr))

    lines = [
        "| variant | ATE RMSE (m) | tracked frac | wall fps | "
        "computation fps | drop counters |",
        "|---|---|---|---|---|---|",
    ]
    for name, r in rows:
        ate = f"{r['ate']:.4f}" if r["ate"] is not None else "FAIL"
        tr = f"{r['tracked']:.2f}" if r["tracked"] is not None else "-"
        fps = f"{r['fps']:.1f}" if r["fps"] else "-"
        cfps = f"{r['comp_fps']:.1f}" if r["comp_fps"] else "-"
        lines.append(f"| {name} | {ate} | {tr} | {fps} | {cfps} | "
                     f"{r['drops'] or '-'} |")
    table = "\n".join(lines)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")


if __name__ == "__main__":
    main()
