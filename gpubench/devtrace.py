"""The reduction of one profiler stretch of the job's thread to device
numbers: busy seconds (the union of the device's records), each device
operation's count and time, the ones that took most time, and the
longest idle gaps, each named by the innermost host event under its
middle."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

TOP = 10


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(dev: List[Tuple[int, int, str]],
           host: List[Tuple[int, int, str]]) -> Optional[Dict]:
    """``dev``, ``host``: (start ns, end ns, name) records of the stretch.
    The window is the span of its records, from the first to the last.
    None when the device recorded nothing."""

    if not dev:
        return None
    busy = union([(s, e) for s, e, _ in dev])
    by_name: Dict[str, int] = {}
    count: Dict[str, int] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
        count[name] = count.get(name, 0) + 1
    lo = min([s for s, _, _ in host] + [busy[0][0]])
    hi = max([e for _, e, _ in host] + [busy[-1][1]])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(mid: int) -> str:
        under = [(e - s, name) for s, e, name in host if s <= mid <= e]
        return min(under)[1] if under else "(no host event)"

    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_ops": [[n, t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[doing((s + e) // 2), (e - s) / 1e9]
                      for s, e in gaps[:TOP]],
        "kernels": {n: (count[n], t / 1e9) for n, t in by_name.items()},
    }


def from_events(events) -> Optional[Dict]:
    """:func:`reduce` over Kineto events (``kineto_results.events()``)."""

    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    return reduce(dev, host)


def mean_call_s(stretch: Dict, kernel: str) -> Optional[float]:
    """Mean device seconds of the records whose name holds ``kernel``."""

    n = t = 0
    for name, (c, secs) in stretch["kernels"].items():
        if kernel in name:
            n, t = n + c, t + secs
    return t / n if n else None
