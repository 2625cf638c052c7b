"""Mean host time of a ``shared_scan_device`` call less its kernel
launches (the dispatcher's pricing, allocation and canonical view), from
the program's own spans: ``scan.shared_scan_device`` less its
``launch.*`` children, over the spans closed outside the traced slice.
None where the program has no such span."""


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = ns = 0
    for path, (count, total, _) in totals.items():
        if path[-1] == "scan.shared_scan_device":
            calls += count
            ns += total - sum(t for p, (_, t, _) in totals.items()
                              if p[:-1] == path and p[-1].startswith("launch."))
    return ns / calls / 1e6 if calls else None
