"""Host time a ``shared_scan_device`` call spends choosing its tier
(``scan.pick_tier``) and building the tier's host program
(``scan.program``: the keys or window tables, cached per key set), from
the program's own spans, over the spans closed outside the traced slice.
None where the program has no such span."""

PARTS = ("scan.pick_tier", "scan.program")


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = sum(c for p, (c, _, _) in totals.items() if p[-1] == "scan.shared_scan_device")
    ns = sum(t for p, (_, t, _) in totals.items()
             if len(p) > 1 and p[-2] == "scan.shared_scan_device" and p[-1] in PARTS)
    return ns / calls / 1e6 if calls else None
