"""supereight-tpu: a dense volumetric SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
emanuelev/supereight (octree-based KinectFusion-style SLAM, Vespa et al.
RA-L 2018). The pointer octree is replaced by a Morton-keyed pool of dense
8x8x8 voxel blocks plus a dense mip pyramid for coarse (internal-node)
values, so that every pipeline stage (preprocess / track / integrate /
raycast) is a batched, fixed-shape XLA program.

Layer map (mirrors reference layers, see SURVEY.md section 1):
  core/      -- the map structure        (ref: se_core)
  ops/       -- per-stage compute        (ref: se_denseslam/src/*.cpp)
  fields/    -- TSDF / occupancy plugins (ref: volume_traits.hpp, kfusion/, bfusion/)
  pipeline   -- orchestration            (ref: DenseSLAMSystem)
  io/        -- datasets, meshes, snapshots (ref: se_apps/interface.h, se_tools)
  parallel/  -- multi-chip sharding      (new capability; no reference equivalent)
  eval/      -- ATE / RPE harness        (ref: se_apps/scripts, ported to py3)
"""

__version__ = "0.1.0"

from supereight_tpu.core.map import MapGeometry, MapState, make_map  # noqa: F401
from supereight_tpu.fields import TSDF, OFUSION, get_field  # noqa: F401
