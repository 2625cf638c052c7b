"""Mean host wall time of a ``shared_scan_device`` call, without a sync
(dispatch, allocation, launch), over the window's untraced operations."""


def read(run):
    times = run.host_seconds.get("shared_scan_device")
    return sum(times) / len(times) * 1e3 if times else None
