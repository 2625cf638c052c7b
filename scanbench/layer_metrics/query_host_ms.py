"""Mean host wall time of a ``query.evaluate`` call, without a sync
(planning, launches, the popcount's dispatch), over the window's untraced
operations."""


def read(run):
    times = run.host_seconds.get("evaluate")
    return sum(times) / len(times) * 1e3 if times else None
