"""Spans and counters of the locked engine and the wideband receiver
(their timing=True): host spans, CUDA event pairs around the device
programs, and one record a resolved block of both, with the block's
launch counters.

Host spans are timed with time.perf_counter_ns and opened as profiler CPU
ranges named "opv.<name>", so in a torch.profiler trace they lie on the
trace's clock.  The range is torch's function-scope RecordFunction
(_RecordFunctionFast), not record_function's user scope: a CUDA trace
mirrors user-scope ranges onto the device timeline, and these must not
read as device work there.  A span's time is kept under its path, the
names of the spans open around it and its own joined by "/"
("launch/sync_wait"); the depth-0 spans are the top-level ones, which
together cover a feed().

Device spans are CUDA event pairs on the device's current stream, kept in
launch order and read only once their end event has completed (a query,
never a wait): each block record takes the pairs completed by then, so a
pair queued behind the resolved block is read at a later resolve.  On the
CPU no device span is recorded.

With timing off the engine holds no recorder, and each span site enters
OFF, a shared no-op context: no event, no profiler range, no allocation.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

#: the no-op context of a span site while timing is off
OFF = contextlib.nullcontext()
#: the profiler ranges' name prefix
PREFIX = "opv."


class _HostSpan:
    __slots__ = ("rec", "name", "path", "rng", "t0")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack
        self.path = (f"{stack[-1].path}/{self.name}" if stack
                     else self.name)
        stack.append(self)
        self.rng = self.rec._range(PREFIX + self.name)
        self.rng.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.rng.__exit__(*exc)
        rec = self.rec
        rec._stack.pop()
        rec._host[self.path] = rec._host.get(self.path, 0) + dt


class _DevicePair:
    __slots__ = ("rec", "name", "device", "start")

    def __init__(self, rec, name, device):
        self.rec = rec
        self.name = name
        self.device = device

    def __enter__(self):
        self.start = self.rec._record(self.device)

    def __exit__(self, *exc):
        end = self.rec._record(self.device)
        self.rec._pairs.append((self.name, self.device, self.start, end))


class Recorder:
    """Host spans, device event pairs and the per-block record."""

    def __init__(self):
        self._range = torch._C._profiler._RecordFunctionFast
        self._stack = []                       # open host spans
        self._host = {}                        # path -> ns since the record
        self._pairs = collections.deque()      # queued, not yet read
        self._device = {}                      # name -> [ms] since the record
        self._free = collections.defaultdict(list)  # device -> read events

    def span(self, name: str):
        """A host span (a context): perf_counter_ns and a profiler range."""
        return _HostSpan(self, name)

    def pair(self, name: str, device):
        """A device span (a context): CUDA events before and after what it
        queues on `device`'s current stream; OFF on the CPU."""
        if device.type != "cuda":
            return OFF
        return _DevicePair(self, name, device)

    def _record(self, device):
        free = self._free[device]
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _read(self):
        """Every queued pair whose end event has completed, in order."""
        while self._pairs:
            name, device, start, end = self._pairs[0]
            if not end.query():
                break
            self._pairs.popleft()
            self._device.setdefault(name, []).append(start.elapsed_time(end))
            self._free[device] += (start, end)

    def block(self, launch: str, programs: int, retime: bool,
              rehunt: bool) -> dict:
        """The record of a resolved block: its counters, the host ms of
        every span path closed since the last record, and the device ms of
        every pair completed by now.  Starts the next record afresh."""
        self._read()
        host = {k: v * 1e-6 for k, v in self._host.items()}
        device, self._host, self._device = self._device, {}, {}
        return dict(launch=launch, programs=programs, retime=retime,
                    rehunt=rehunt, host_ms=host, device_ms=device)


def top_level_ms(record: dict) -> float:
    """The host ms of a block record's top-level spans."""
    return sum(v for k, v in record["host_ms"].items() if "/" not in k)


def leaf_ms(record: dict, name: str, under: str | None = None) -> float:
    """The host ms of a block record's spans named `name`, wherever they
    were open (or only inside the top-level span `under`)."""
    return sum(v for k, v in record["host_ms"].items()
               if k.rsplit("/", 1)[-1] == name
               and (under is None or k.startswith(under + "/")))
