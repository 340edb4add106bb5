"""Multi-chip sharding of the SLAM frame step.

No reference equivalent: supereight is single-process shared-memory
OpenMP (SURVEY.md section 2.4). The scaling design follows the standard
JAX recipe — pick a mesh, annotate shardings, let XLA insert the
collectives (NCCL over NVLink between GPUs):

* **Pixel-parallel** (the data-parallel axis): depth frames and all image
  maps are sharded by rows. Preprocess, per-pixel tracking residuals, and
  the raycast march are embarrassingly parallel over rows; the only
  cross-device traffic tracking needs is the 32-float normal-equation
  reduction (an automatic psum) and boundary gathers into the reference
  maps.

* **Map-parallel** (the model-parallel axis): the voxel-block pool is
  sharded along the slot dimension, so fusion writes stay local to the
  owning device; raycast/interp reads of remote bricks become XLA-inserted
  gathers (the halo exchange — a frustum-filtered explicit version is the
  planned refinement).

Slot assignment is round-robin by allocation order, which spreads
spatially adjacent blocks across devices (good for fusion load balance).
"""

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supereight_tpu.core.map import MapState
from supereight_tpu.parallel.step import FrameState

AXIS = "shards"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def frame_state_shardings(mesh: Mesh, state: FrameState) -> FrameState:
    """Build a FrameState of NamedShardings matching ``state``'s pytree."""
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    rep = s()
    nl = len(state.map.mip_x)
    map_sh = MapState(
        data_x=s(AXIS, None), data_y=s(AXIS, None),
        block_coord=s(AXIS, None), active=s(AXIS),
        slot=rep, n_blocks=rep,
        mip_x=tuple(rep for _ in range(nl)),
        mip_y=tuple(rep for _ in range(nl)),
        mip_alloc=tuple(rep for _ in range(nl)),
    )
    return FrameState(
        map=map_sh, pose=rep, raycast_pose=rep,
        vertex=s(AXIS, None, None), normal=s(AXIS, None, None),
        valid=s(AXIS, None),
    )


def shard_frame_state(mesh: Mesh, state: FrameState) -> FrameState:
    """Place a FrameState onto the mesh with the canonical shardings."""
    sh = frame_state_shardings(mesh, state)
    return jax.tree.map(jax.device_put, state, sh)


def image_sharding(mesh: Mesh):
    return NamedSharding(mesh, P(AXIS, None))
