import sys

from shared_simd_scan_tpu_torch.bench.cli import main

sys.exit(main())
