from .sharding import (
    RAY_AXIS, Mesh, ShardedBatch, make_mesh, pad_to_multiple, replicate_env, run_shards,
    shard_rays,
)
from .dryrun import dryrun_multichip
