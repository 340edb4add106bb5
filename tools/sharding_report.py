"""Virtual-mesh scaling report for the explicit-halo sharded step.

Runs parallel/dist_step on 1/2/4/8 virtual CPU devices over the same
scene and reports, per mesh size:
  * per-device block ownership (morton-range balance),
  * halo blocks exchanged per frame (+ bytes),
  * collective bytes per step from the COMPILED HLO (all-gather /
    all-reduce / reduce-scatter / collective-permute output shapes),
  * the tracked flag and drop counters.

It measures counts and bytes, never time: a virtual CPU mesh says
nothing about how long a step takes on GPUs.

Writes the markdown table to stdout (checked into SHARDING.md).
"""

import functools
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from supereight_tpu.core.map import MapGeometry  # noqa: E402
from supereight_tpu.fields import get_field  # noqa: E402
from supereight_tpu.io import synthetic  # noqa: E402
from supereight_tpu.parallel import dist_step  # noqa: E402

W, H = 160, 120
DIM = 4.8
SIZE = 256
K = (120.0, 120.0, 80.0, 60.0)
N_FRAMES = 8
CAP_GLOBAL = 8192

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
                "pred": 1, "s8": 1, "u8": 1, "f64": 8, "s64": 8}
_COLL_RE = re.compile(
    r"= (\w+)\[([\d,]*)\][^ ]* (all-gather|all-reduce|reduce-scatter|"
    r"collective-permute)")


def collective_bytes(compiled_text):
    total = 0
    counts = {}
    for m in _COLL_RE.finditer(compiled_text):
        dtype, dims, op = m.groups()
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 4)
        counts[op] = counts.get(op, 0) + 1
    return total, counts


def run(n_dev):
    field = get_field("tsdf")
    geom_l = MapGeometry(size=SIZE, dim=DIM,
                         capacity=CAP_GLOBAL // n_dev)
    depths, poses = synthetic.orbit_sequence(
        N_FRAMES, K, width=W, height=H, radius=0.35 * DIM,
        center=(DIM / 2,) * 3, sphere_radius=0.15 * DIM, angle_span=0.5,
        room=((0.35,) * 3, (DIM - 0.35,) * 3))
    mesh = dist_step.make_mesh(n_dev)
    step = dist_step.make_dist_step(
        mesh, geom_l, field, frame_size=(W, H), iterations=(4, 3, 2),
        mu=0.1, icp_threshold=1e-5, frustum_halo=True)
    state = dist_step.init_dist_state(mesh, geom_l, field, (W, H),
                                      poses[0])
    kj = jnp.asarray(K, jnp.float32)
    gt0 = jnp.eye(4, dtype=jnp.float32)

    lowered = jax.jit(lambda s, d, kk, f, g: step(s, d, kk, f, g)).lower(
        state, jnp.asarray(depths[0]), kj, jnp.int32(4), gt0)
    cbytes, counts = collective_bytes(lowered.compile().as_text())

    aux = None
    donated = None
    for i, d in enumerate(depths):
        prev = state
        state, aux = step(state, jnp.asarray(d), kj, jnp.int32(i), gt0)
        if donated is None:
            # donation proof: the input pool buffer must be consumed
            # (aliased into the output) rather than copied
            jax.block_until_ready(state)
            donated = prev.map.data_x.is_deleted()
    jax.block_until_ready(state)
    per_dev = np.asarray(aux["n_blocks_dev"])
    return {
        "n_dev": n_dev,
        "blocks_total": int(per_dev.sum()),
        "blocks_min": int(per_dev.min()),
        "blocks_max": int(per_dev.max()),
        "halo_blocks": int(aux["halo_blocks"]),
        "halo_mb": int(aux["halo_blocks"]) * 512 * 2 / 1e6,
        "coll_mb": cbytes / 1e6,
        "coll_ops": counts,
        "pool_donated": donated,
        "tracked": bool(aux["tracked"]),
        "drops": (int(aux["alloc_overflow"]),
                  int(aux["blocks_truncated"]),
                  int(aux["ray_overflow"]),
                  int(aux["halo_overflow"])),
    }


def main():
    rows = [run(n) for n in (1, 2, 4, 8)]
    print("| devices | blocks/dev (min-max, total) | halo blocks/frame "
          "(MB) | collective MB/step (ops) | "
          "tracked | drops (alloc,trunc,ray,halo) |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        ops = ", ".join(f"{k}x{v}" for k, v in sorted(r["coll_ops"].items()))
        print(f"| {r['n_dev']} | {r['blocks_min']}-{r['blocks_max']} "
              f"(total {r['blocks_total']}) | {r['halo_blocks']} "
              f"({r['halo_mb']:.1f} MB) | {r['coll_mb']:.1f} ({ops}) | "
              f"{r['tracked']} | {r['drops']} |")
    assert all(r["pool_donated"] for r in rows), \
        [r["pool_donated"] for r in rows]
    print("\npool buffers donated in place on every mesh size "
          "(input pool consumed, no copy-on-write).")


if __name__ == "__main__":
    main()
