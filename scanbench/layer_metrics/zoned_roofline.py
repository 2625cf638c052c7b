"""A pruned flight-1 query's semantic bytes (its four columns over the rows
of the zones its date range admits, and its answer) at the card's
data-sheet rate, over the device time of every kernel, memset and copy its
calls into the port launched (traced slice), in %."""


def read(run):
    return run.roofline_pct("ssb_flight1_zoned")
