"""shared_simd_scan_tpu_torch — the shared scan on PyTorch and CUDA.

The port of ``shared_simd_scan_tpu`` (JAX/Pallas) to PyTorch with
hand-written CUDA kernels for Hopper (sm_90a).  This slice covers the
library's main path: pack a column into the tile layout, run the k-key
shared scan (interval tier for consecutive keys, compare tier otherwise)
and the single-key scan, and decompress.  Module names mirror the JAX
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
from shared_simd_scan_tpu_torch.ops.scan import (  # noqa: F401
    scan_device,
    shared_scan_device,
    interval_scan_device,
)
from shared_simd_scan_tpu_torch.ops.unpack import (  # noqa: F401
    pack_device_kernel,
    unpack_device,
)

__version__ = "0.1.0"
