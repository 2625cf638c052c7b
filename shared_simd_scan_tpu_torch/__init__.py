"""shared_simd_scan_tpu_torch — the shared scan on PyTorch and CUDA.

The port of ``shared_simd_scan_tpu`` (JAX/Pallas) to PyTorch with
hand-written CUDA kernels for Hopper (sm_90a).  It covers packing a
column into the tile layout and decompressing it, every tier of the k-key
shared scan and the single-key scan, the range scan, the fused
multi-column conjunction, the IN-list member scan, the predicate-tree
query layer (``query.evaluate``, with zone-map pruning), the linear
(interleaved) export (``shared_scan_linear_device``), the aggregates:
keyed SUM/COUNT and MIN/MAX, and SUM/COUNT under a bitvector; the value
histogram and the statistics drawn from it (``stats``), zone maps
(``zonemap``), the FOR and dictionary encodings (``forcol``, ``dictcol``),
NULL-aware evaluation (``nullable``), persistence (``io``) and the
profiling and debug utilities (``utils``).  Module names mirror the JAX
package; the port imports torch and numpy and never jax.
"""

from shared_simd_scan_tpu_torch.layout import (  # noqa: F401
    PackedColumn,
    DeviceColumn,
    from_jax_numpy,
    pack,
    pack_device,
    to_device,
    to_canonical,
    packed_nbytes,
    unpack_schedule,
)
from shared_simd_scan_tpu_torch import bitvector  # noqa: F401
from shared_simd_scan_tpu_torch import io  # noqa: F401
from shared_simd_scan_tpu_torch import query  # noqa: F401
from shared_simd_scan_tpu_torch import stats  # noqa: F401
from shared_simd_scan_tpu_torch import forcol  # noqa: F401
from shared_simd_scan_tpu_torch import dictcol  # noqa: F401
from shared_simd_scan_tpu_torch import nullable  # noqa: F401
from shared_simd_scan_tpu_torch import zonemap  # noqa: F401
from shared_simd_scan_tpu_torch.ops.scan import (  # noqa: F401
    scan_device,
    shared_scan_device,
    shared_scan_linear_device,
    interval_scan_device,
    range_scan_device,
    histogram_device,
)
from shared_simd_scan_tpu_torch.ops.member import (  # noqa: F401
    member_scan_device,
)
from shared_simd_scan_tpu_torch.ops.conj import (  # noqa: F401
    conj_range_scan_device,
    conj_eq_scan_device,
)
from shared_simd_scan_tpu_torch.ops.aggregate import (  # noqa: F401
    aggregate_scan_device,
    minmax_scan_device,
    masked_aggregate_device,
)
from shared_simd_scan_tpu_torch.ops.unpack import (  # noqa: F401
    pack_device_kernel,
    unpack_device,
)

__version__ = "0.1.0"
