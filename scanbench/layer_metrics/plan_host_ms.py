"""Host time a ``query.evaluate`` call spends planning (``query.plan``:
the columns' checks, the grouping, the bound arrays), from the program's
own spans, over the spans closed outside the traced slice.  None where the
program has no such span."""


def read(run):
    try:
        from shared_simd_scan_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    totals = span_totals()
    calls = sum(c for p, (c, _, _) in totals.items() if p[-1] == "query.evaluate")
    ns = sum(t for p, (_, t, _) in totals.items()
             if p[-1] == "query.plan" and "query.evaluate" in p)
    return ns / calls / 1e6 if calls else None
