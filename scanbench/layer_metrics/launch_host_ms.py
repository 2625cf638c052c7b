"""Mean host time of one kernel launch inside an operation: the
program's ``launch.*`` spans (the stream lookup and the ctypes call)
nested in an operator's span, over the spans closed outside the traced
slice; set-up's top-level pack launches are left out.  None where the
program has no such span."""


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    calls = ns = 0
    for path, (count, total, _) in span_totals().items():
        if len(path) > 1 and path[-1].startswith("launch."):
            calls += count
            ns += total
    return ns / calls / 1e6 if calls else None
