"""Multi-device sharding tests on the virtual 8-CPU mesh.

The reference has nothing distributed (SURVEY.md 2.4); these tests gate
the multi-device capability: the fused frame step compiles and runs
with the pool sharded over slots and images sharded over rows, and
produces the same trajectory as the single-device path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supereight_tpu.core.map import MapGeometry
from supereight_tpu.fields import get_field
from supereight_tpu.io import synthetic
from supereight_tpu.parallel import sharding, step as pstep

N_DEV = 8
W, H = 64, 48
DIM = 2.0
K = (48.0, 48.0, 32.0, 24.0)


@pytest.fixture(scope="module")
def setup():
    geom = MapGeometry(size=64, dim=DIM, capacity=64 * N_DEV)
    field = get_field("tsdf")
    depths, poses = synthetic.orbit_sequence(
        6, K, width=W, height=H, radius=0.4 * DIM, center=(DIM / 2,) * 3,
        sphere_radius=0.15 * DIM, angle_span=0.3,
        room=((0.15,) * 3, (DIM - 0.15,) * 3))
    fn = functools.partial(
        pstep.frame_step, geom, field,
        frame_size=(W, H), iterations=(3, 2),
        mu=0.1, icp_threshold=1e-5, neg_y=False, filter_input=False,
        use_gt_pose=False, integration_rate=1, tracking_rate=1)
    return geom, field, depths, poses, fn


def _run(fn, geom, field, depths, poses, mesh=None):
    state = pstep.init_frame_state(geom, field, (W, H), poses[0])
    if mesh is not None:
        state = sharding.shard_frame_state(mesh, state)
    outs = []
    for i, d in enumerate(depths):
        d = jnp.asarray(d)
        if mesh is not None:
            d = jax.device_put(d, sharding.image_sharding(mesh))
        state, aux = fn(state, d, jnp.asarray(K, jnp.float32),
                        jnp.int32(i))
        outs.append(np.asarray(state.pose))
    return state, outs


def test_devices_available():
    assert len(jax.devices()) >= N_DEV


def test_sharded_step_runs(setup):
    geom, field, depths, poses, fn = setup
    mesh = sharding.make_mesh(N_DEV)
    state, traj = _run(fn, geom, field, depths, poses, mesh)
    assert int(state.map.n_blocks) > 10
    assert np.isfinite(traj[-1]).all()


def test_sharded_matches_single_device(setup):
    geom, field, depths, poses, fn = setup
    mesh = sharding.make_mesh(N_DEV)
    _, traj_s = _run(fn, geom, field, depths, poses, mesh)
    _, traj_1 = _run(fn, geom, field, depths, poses, None)
    # same program, same data -> trajectories agree to float tolerance
    np.testing.assert_allclose(traj_s[-1], traj_1[-1], atol=1e-3)


def test_fused_step_matches_class_pipeline(setup):
    """The one-dispatch frame_step must reproduce the stage-level
    DenseSLAMSystem trajectory."""
    from supereight_tpu.config import Configuration
    from supereight_tpu.pipeline import DenseSLAMSystem

    geom, field, depths, poses, fn = setup
    _, traj_f = _run(fn, geom, field, depths, poses, None)

    cfg = Configuration(volume_resolution=64, volume_size=DIM, mu=0.1,
                        camera=K, compute_size_ratio=1, integration_rate=1,
                        pyramid=(3, 2), block_capacity=64 * N_DEV)
    pipe = DenseSLAMSystem((W, H), cfg, init_pose=poses[0])
    for i, d in enumerate(depths):
        pipe.process_frame(d, i, is_mm=False)
    # XLA fuses the two programs differently -> reduction rounding differs;
    # gate trajectory-level agreement, not bitwise identity
    np.testing.assert_allclose(traj_f[-1], pipe.get_pose(), atol=5e-3)
