"""The 95th percentile of every operation's latency in the window, issue to
answer on the host, host clock."""
import numpy as np


def read(run):
    return float(np.percentile([r.latency_s for r in run.records], 95)) * 1e3
