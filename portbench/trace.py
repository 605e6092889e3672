"""Reading a torch.profiler trace of the measured window: the device's busy
time, the kernels' times by name, the longest idle gaps named by what the
host was doing, and the top device operations."""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

#: the harness's own spans (torch.profiler.record_function) start so
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict        # name -> (total seconds, count)
    idle_gaps: list      # [(label, seconds)], longest first
    device_ops: list     # [(name, seconds)], longest first


def _label(name: str) -> str:
    """A device operation's name in the allowed characters, at most 64."""
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, t_start_ns: int, t_end_ns: int, top: int = 10) -> Trace:
    """The trace of `prof` between host times t_start_ns and t_end_ns (the
    traced window, on the profiler's clock)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if d <= 0 or s + d <= t_start_ns or s >= t_end_ns:
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.name().startswith(SPAN_PREFIX):
                continue                  # a span's mirror on the device
            dev.append((max(s, t_start_ns), min(s + d, t_end_ns), e.name()))
        elif e.device_type() == DeviceType.CPU:
            host.append((s, s + d, e.name()))
    kernels = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        kernels[name][0] += (e - s) * 1e-9
        kernels[name][1] += 1
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps, prev = [], t_start_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t_end_ns > prev:
        gaps.append((prev, t_end_ns))
    spans = sorted(h for h in host if h[2].startswith(SPAN_PREFIX))
    ops = sorted(h for h in host if not h[2].startswith(SPAN_PREFIX))
    span_starts = [h[0] for h in spans]
    op_starts = [h[0] for h in ops]
    by_label = defaultdict(float)
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        # the innermost harness span and program op around the midpoint
        span = "host"
        i = bisect.bisect_right(span_starts, mid)
        for s, e, name in reversed(spans[max(0, i - 8):i]):
            if s <= mid < e:
                span = name
                break
        op = ""
        i = bisect.bisect_right(op_starts, mid)
        for s, e, name in reversed(ops[max(0, i - 64):i]):
            if s <= mid < e:
                op = name
                break
        by_label[_label(f"{span}_{op}" if op else span)] += (ge - gs) * 1e-9
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    top_ops = sorted(((_label(n), v[0]) for n, v in kernels.items()),
                     key=lambda kv: -kv[1])[:top]
    return Trace(window_s=(t_end_ns - t_start_ns) * 1e-9, busy_s=busy_s,
                 kernels={n: tuple(v) for n, v in kernels.items()},
                 idle_gaps=idle, device_ops=top_ops)


def kernel_mean_s(trace: Trace, fragment: str):
    """(mean seconds a launch, launches) of the kernels whose name holds
    `fragment`, or None where the window launched none."""
    tot, n = 0.0, 0
    for name, (s, c) in trace.kernels.items():
        if fragment in name:
            tot += s
            n += c
    return (tot / n, n) if n else None
