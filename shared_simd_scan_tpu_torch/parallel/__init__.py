"""Multi-device and multi-process parallelism: meshes and sharded scans."""

from shared_simd_scan_tpu_torch.parallel.dist import (  # noqa: F401
    initialize,
    make_mesh,
    shard_column,
    sharded_shared_scan,
    sharded_scan,
    sharded_unpack,
    sharded_interval_scan,
    sharded_range_scan,
)
