"""What a traced slice of the window shows: ``torch.profiler``'s trace of a
few seconds, with each device operation (kernel, memset, copy) joined to
the benchmark's span of the call into the port that launched it, and so to
its operation, by the launch's correlation id, never by kernel name.

The slice is exported as a Chrome trace (kineto's format: ``ts`` and
``dur`` in microseconds on the host's timeline, device events aligned to
it) into the run's temporary directory, read, and deleted.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

OP_SPAN = "scanbench.op"
SPAN_PREFIX = "scanbench."
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class Slice:
    op_device_s: list[float]  # device time the port's calls launched, each traced operation
    client_device_s: float  # device time launched in operations outside the port's calls
    busy_s: float  # time in which some device operation ran, within the window
    window_s: float  # first traced operation's start to the last one's end
    device_ops: list[list]  # [name, seconds], the device operations that took most time
    idle_gaps: list[list]  # [what the host was doing, seconds], the most idle time
    device_events: int
    joined_events: int


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _host_label(stack: list[dict]) -> str:
    """The innermost benchmark span and the innermost host event in it."""
    if not stack:
        return "between operations"
    spans = [e["name"] for e in stack if e["name"].startswith(SPAN_PREFIX)]
    inner = stack[-1]["name"]
    if not spans:
        return inner
    return spans[-1] if inner == spans[-1] else f"{spans[-1]} > {inner}"


def _name_gaps(host: list[dict], gaps: list[tuple[float, float]]) -> dict[str, float]:
    """Sum each gap's length under what the host thread was inside at its
    midpoint; ``host`` holds one thread's nested events, sorted by
    (start, -duration)."""
    totals: dict[str, float] = defaultdict(float)
    stack: list[dict] = []
    i = 0
    for lo, hi in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (lo + hi) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            e = host[i]
            i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        totals[_host_label(stack)] += hi - lo
    return totals


def summarize(path: str) -> Slice | None:
    """Read the Chrome trace at ``path``; None when it holds no traced
    operation."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(SPAN_PREFIX)), key=lambda e: e["ts"])
    ops = [e for e in spans if e["name"] == OP_SPAN]
    calls = [e for e in spans if e["name"] != OP_SPAN]
    if not ops:
        return None
    thread = (ops[0]["pid"], ops[0]["tid"])
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]

    def within(starts: list[float], outer: list[dict], at: float) -> int:
        i = bisect.bisect_right(starts, at) - 1
        return i if i >= 0 and at <= outer[i]["ts"] + outer[i]["dur"] else -1

    op_starts, call_starts = [o["ts"] for o in ops], [c["ts"] for c in calls]
    op_device = [0.0] * len(ops)
    client = 0.0
    joined = 0
    for e in device:
        at = launched.get(e.get("args", {}).get("correlation"))
        i = -1 if at is None else within(op_starts, ops, at)
        if i < 0:
            continue
        joined += 1
        if within(call_starts, calls, at) >= 0:
            op_device[i] += e["dur"]
        else:
            client += e["dur"]
    w0, w1 = ops[0]["ts"], ops[-1]["ts"] + ops[-1]["dur"]
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device
                   if e["ts"] < w1 and e["ts"] + e["dur"] > w0])
    gaps, at = [], w0
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if at < w1:
        gaps.append((at, w1))
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and (e["pid"], e["tid"]) == thread), key=lambda e: (e["ts"], -e["dur"]))
    by_kernel: dict[str, float] = defaultdict(float)
    for e in device:
        if e["ts"] < w1 and e["ts"] + e["dur"] > w0:
            by_kernel[e["name"]] += e["dur"]

    def top(totals: dict[str, float]) -> list[list]:
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, us * 1e-6] for name, us in ranked]

    return Slice(
        op_device_s=[us * 1e-6 for us in op_device],
        client_device_s=client * 1e-6,
        busy_s=sum(hi - lo for lo, hi in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        device_ops=top(by_kernel),
        idle_gaps=top(_name_gaps(host, gaps)),
        device_events=len(device),
        joined_events=joined,
    )
