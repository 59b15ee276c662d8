"""The traced slice: torch.profiler over a few jobs or steps at the end.

`Slice` profiles what runs between `start()` and `stop()` (host ops and the
device's kernels and copies).  `summary()` reduces the trace to what the
metric readers take: the device's busy seconds (the union of its events'
intervals) in the slice's wall seconds, the time and count of each device
event by name, and the idle gaps between device events, each named by the
host activity under way when the card went idle (the innermost host op or
benchmark span open at the gap's start).
"""

from __future__ import annotations

import time
from collections import defaultdict

TOP = 10


class Slice:
    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.wall_s = None

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        dev, host = [], []
        for ev in self.prof.events():
            a, b = ev.time_range.start, ev.time_range.end
            if b <= a:
                continue
            on_device = ev.device_type == DeviceType.CUDA
            if on_device and (getattr(ev, "is_user_annotation", False)
                              or ev.name.startswith("bench.")):
                continue  # a host span mirrored on the device's timeline, not work
            (dev if on_device else host).append((a, b, ev.name))
        return reduce(dev, host, self.wall_s)


def reduce(dev: list, host: list, wall_s: float) -> dict:
    """dev, host: (start us, end us, name) events.  Returns busy_s, window_s,
    kernels {name: [count, seconds]}, n_events, device_ops and idle_gaps
    (the top entries as [name, seconds])."""
    dev = sorted(dev)
    kernels = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy_us, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy_us += cur_b - cur_a
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy_us += cur_b - cur_a
    idle = defaultdict(float)
    host = sorted(host)
    for g0, g1 in gaps:
        idle[_host_at(host, g0)] += (g1 - g0) * 1e-6
    top = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(busy_s=busy_us * 1e-6, window_s=wall_s, n_events=len(dev),
                kernels={n: list(v) for n, v in kernels.items()},
                device_ops=top({n: v[1] for n, v in kernels.items()}), idle_gaps=top(idle))


def _host_at(host: list, t: float) -> str:
    """The innermost (latest-starting) host event open at time t."""
    import bisect

    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for a, b, name in reversed(host[max(0, i - 2000):i]):
        if b >= t:
            return name
    return "no host op"
