"""Block rows the pruned passes read over the block rows of the zones the
zone maps admitted, in % (100 where a pass reads nothing more), from the
program's counters ``zonemap.block_rows_scanned`` and
``zonemap.block_rows_admitted`` over the run.  None where the program has
no such counter."""


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    seen = counters()
    scanned = seen.get("zonemap.block_rows_scanned", 0)
    admitted = seen.get("zonemap.block_rows_admitted", 0)
    return 100.0 * scanned / admitted if admitted else None
