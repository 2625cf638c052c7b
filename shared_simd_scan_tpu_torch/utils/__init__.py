"""Utilities: profiling/timing and debug dumps (the reference's L2 support
layer), the PyTorch counterpart of ``shared_simd_scan_tpu.utils``."""

from shared_simd_scan_tpu_torch.utils.profiling import (  # noqa: F401
    ProfileSample,
    clock_ns,
    get_sample,
    profile_block,
    profiling_enabled,
    reset_samples,
    trace,
)
from shared_simd_scan_tpu_torch.utils.debug import dump_byte, dump_memory  # noqa: F401
