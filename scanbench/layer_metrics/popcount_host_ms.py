"""Host time a ``query.evaluate`` call spends issuing its count
(``query.popcount``: the SWAR popcount's elementwise passes and sum,
dispatched, not waited for), from the program's own spans, over the spans
closed outside the traced slice.  None where the program has no such
span."""


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = sum(c for p, (c, _, _) in totals.items() if p[-1] == "query.evaluate")
    ns = sum(t for p, (_, t, _) in totals.items()
             if p[-1] == "query.popcount" and "query.evaluate" in p)
    return ns / calls / 1e6 if calls else None
