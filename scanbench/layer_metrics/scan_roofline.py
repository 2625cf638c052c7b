"""A shared scan's semantic bytes at the card's data-sheet rate, over the
device time of every kernel, memset and copy its call into the port
launched (traced slice), in %."""


def read(run):
    return run.roofline_pct("shared_scan")
