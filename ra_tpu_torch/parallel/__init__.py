"""Device-mesh sharding of the lane engine (``parallel/mesh.py``)."""
from .mesh import (LaneMesh, drive_uniform_window, ingress_submit_wave,
                   ladder_rungs, lane_ladder, lane_mesh, mesh_shapes,
                   mesh_superstep_driver, per_device_wal_shards,
                   shard_engine_state, state_shardings,
                   superstep_block_shardings)

__all__ = ["LaneMesh", "drive_uniform_window", "ingress_submit_wave",
           "ladder_rungs", "lane_ladder", "lane_mesh", "mesh_shapes",
           "mesh_superstep_driver", "per_device_wal_shards",
           "shard_engine_state", "state_shardings",
           "superstep_block_shardings"]
