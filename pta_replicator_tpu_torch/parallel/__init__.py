"""The bounded-window stage-graph executor (``stages.py``), the sweep's
dispatch -> readback -> write pipeline (``pipeline.py``), the
host-to-device tile prefetcher with its plane-tile cache
(``prefetch.py``), the device mesh and its sharded engine (``mesh.py``)
and the multi-process helpers (``distributed.py``)."""
from . import distributed, pipeline, prefetch, stages
from .mesh import make_mesh, shard_batch, sharded_realize, shardmap_realize, static_delays
from .pipeline import DrainTimeout, run_pipelined
from .prefetch import load_plane_tiles, load_plane_tiles_meta, prefetch_to_device, save_plane_tiles
from .stages import Stage, StageGraph, fan_out

__all__ = [
    "distributed",
    "pipeline",
    "prefetch",
    "stages",
    "Stage",
    "StageGraph",
    "fan_out",
    "make_mesh",
    "shard_batch",
    "sharded_realize",
    "shardmap_realize",
    "static_delays",
    "DrainTimeout",
    "run_pipelined",
    "prefetch_to_device",
    "save_plane_tiles",
    "load_plane_tiles",
    "load_plane_tiles_meta",
]
