"""Queries answered in the window over the window's seconds (a batch of k
keys answers k queries)."""


def read(run):
    return sum(r.queries for r in run.records) / run.window_s
