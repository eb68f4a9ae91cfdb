"""The traced slice of a run: ``torch.profiler`` over a steady part of the window, reduced to device intervals,
the benchmark's own spans, the host's operations and the port's launch counters.

Starting the profiler takes seconds (CUPTI's set-up), so a driver ends a traced window ``trace_seconds`` after
the slice has started, past ``--seconds`` where need be, and reads its rates from the untraced part before it.

The profile opens with 1,024 small kernels, waited for, before the slice (the port's ``profiling.trace``
pattern: late in a process a trace has lost the records of its first launches; the warm-up's kernels take
that loss). Nothing is written to disk: the events are read from the profiler in memory.
"""

from __future__ import annotations

import bisect

import torch

WARMUP_LAUNCHES = 1024
SPAN_PREFIX = "asrbench."


def launch_counts() -> dict:
    """The port's kernel launch counters, by wrapper name."""
    from thunder_tpu_torch.kernels import KERNEL_WRAPPERS

    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


class Slice:
    """``start()`` and ``stop()`` around the traced part of a window; ``result()`` after it."""

    def __init__(self):
        self._prof = None
        self._before = {}
        self.launches = {}
        self.calls: list = []  # the work the slice ran, as the traffic driver records it

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        with torch.profiler.record_function("trace_warmup"):
            x = torch.zeros((), device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize()
        self._before = launch_counts()

    def stop(self) -> None:
        torch.cuda.synchronize()
        after = launch_counts()
        self.launches = {k: after[k] - self._before.get(k, 0) for k in after}
        self._prof.__exit__(None, None, None)

    def result(self) -> dict:
        """Device intervals, the benchmark's spans and the host's operations (microseconds on the profiler's
        clock), the slice's bounds, and the launch counters' deltas."""
        from torch.autograd import DeviceType

        device, spans, host = [], [], []
        warmup_end = 0.0
        for e in self._prof.events():
            start, end = e.time_range.start, e.time_range.end
            annotation = getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)
            if e.device_type == DeviceType.CUDA:
                if not annotation and e.name != "trace_warmup":  # a span's copy on the card's timeline is no work
                    device.append((e.name, start, end))
            elif e.name == "trace_warmup":
                warmup_end = max(warmup_end, end)
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((e.name, start, end))
            else:
                host.append((e.name, start, end))
        device = [d for d in device if d[1] >= warmup_end]
        marks = [s for s in spans if s[0] == SPAN_PREFIX + "slice"]
        lo = min((s[1] for s in marks), default=warmup_end)
        hi = max((s[2] for s in marks), default=max((d[2] for d in device), default=lo))
        return {"device": device, "spans": [s for s in spans if s[0] != SPAN_PREFIX + "slice"], "host": host,
                "bounds": (lo, hi), "launches": self.launches, "calls": self.calls}


def union(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle ``(start, end)`` gaps of ``[lo, hi]`` between the intervals."""
    out, at = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def breakdown(result: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what the host was doing at the middle
    of each gap (its innermost operation), each as ``[[name, seconds], ...]``."""
    lo, hi = result["bounds"]
    by_name: dict = {}
    for name, s, e in result["device"]:
        if e > lo and s < hi:
            by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo)) * 1e-6
    host = sorted(result["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle: dict = {}
    for s, e in gaps([(d[1], d[2]) for d in result["device"]], lo, hi):
        mid = 0.5 * (s + e)
        at = bisect.bisect_right(starts, mid)
        # an operation that holds the middle started at most a few thousand operations before it
        inner = [h for h in host[max(0, at - 4096): at] if h[2] >= mid]
        inner += [h for h in result["spans"] if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host: no operation recorded"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    rank = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
