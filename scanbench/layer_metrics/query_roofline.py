"""A flight-1 query's semantic bytes (three WHEREs and masked sums) at the
card's data-sheet rate, over the device time of every kernel, memset and
copy its calls into the port launched, the popcount's passes included
(traced slice), in %."""


def read(run):
    return run.roofline_pct("ssb_flight1")
