"""Host time a ``query.evaluate`` call spends pruning (``query.prune``: a
mapped And's zone lookups and the intersection of their spans), from the
program's own spans, over the spans closed outside the traced slice.  None
where the program has no such span."""


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = sum(c for p, (c, _, _) in totals.items() if p[-1] == "query.evaluate")
    spans = [t for p, (_, t, _) in totals.items()
             if p[-1] == "query.prune" and "query.evaluate" in p]
    return sum(spans) / calls / 1e6 if calls and spans else None
