"""Worker for the 2-process jax.distributed simulation test.

Each process owns 2 virtual CPU devices; together they form the
4-device mesh that runs the morton-sharded frame step SPMD. Process 0
writes the trajectory to the output file.

Usage: python tools/mp_dist_worker.py <process_id> <num_procs> <out.npy>
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main():
    pid, nprocs, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["SE_COORDINATOR"] = os.environ.get(
        "MP_COORD", "127.0.0.1:8899")
    os.environ["SE_NUM_PROCESSES"] = str(nprocs)
    os.environ["SE_PROCESS_ID"] = str(pid)
    from supereight_tpu.parallel import distributed
    assert distributed.initialize_from_env()
    assert jax.process_count() == nprocs

    from supereight_tpu.core.map import MapGeometry
    from supereight_tpu.fields import get_field
    from supereight_tpu.io import synthetic
    from supereight_tpu.parallel import dist_step

    n_dev = jax.device_count()
    W, H, DIM = 64, 48, 2.0
    K = (48.0, 48.0, 32.0, 24.0)
    geom_l = MapGeometry(size=64, dim=DIM, capacity=256)
    field = get_field("tsdf")
    depths, poses = synthetic.orbit_sequence(
        6, K, width=W, height=H, radius=0.4 * DIM, center=(DIM / 2,) * 3,
        sphere_radius=0.15 * DIM, angle_span=0.3,
        room=((0.15,) * 3, (DIM - 0.15,) * 3))

    mesh = dist_step.make_mesh(n_dev)
    step = dist_step.make_dist_step(
        mesh, geom_l, field, frame_size=(W, H), iterations=(3, 2),
        mu=0.1, icp_threshold=1e-5, frustum_halo=False)
    state = dist_step.init_dist_state(mesh, geom_l, field, (W, H),
                                      poses[0])
    kj = jnp.asarray(K, jnp.float32)
    col_shard = NamedSharding(mesh, P(None, dist_step.AXIS))

    traj = []
    for i, d in enumerate(depths):
        d_np = np.asarray(d)
        dg = jax.make_array_from_callback(
            d_np.shape, col_shard,
            lambda idx, d_np=d_np: d_np[idx])
        state, aux = step(state, dg, kj, jnp.int32(i))
        pose = np.asarray(state.pose.addressable_shards[0].data)
        traj.append(pose)
    per_dev = np.asarray(
        jax.experimental.multihost_utils.process_allgather(
            aux["n_blocks_dev"], tiled=True))
    if pid == 0:
        np.save(out, np.stack(traj))
        np.save(out + ".blocks.npy", per_dev)
    print(f"proc {pid}: done, final pos "
          f"{traj[-1][:3, 3]}, blocks/dev {per_dev}", flush=True)


if __name__ == "__main__":
    main()
