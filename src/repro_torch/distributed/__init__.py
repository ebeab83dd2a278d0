"""Distribution layer of the port on ``torch.distributed``: sharding
rules (FSDP x TP), activation policy, gradient compression, pipeline
parallelism, mesh capture for the planner, and the collectives the mesh
steps run.  A mesh is a ``DeviceMesh`` (``repro_torch.launch.mesh``);
no ``shard_map`` shim is needed.
"""
from . import (act_sharding, collectives, compression, mesh_capture,
               pipeline, sharding)

__all__ = ["act_sharding", "collectives", "compression", "mesh_capture",
           "pipeline", "sharding"]
