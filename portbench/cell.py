"""One run of one cell: set-up, the measured window, the per-layer
readings, and the comparison with the plain reference that decides
`correct` (the cell's check, portbench/checks/<name>.py, named by its
limits file).

The window drives the configuration's receiver the way its CLI does: one
feed() a block advance (a wideband quantum, or a block of every channel),
back to back from card memory, from the first timed feed to the return of
a final flush() (the frames in flight and the buffered tail) and a
synchronize.  Around every call the harness takes the host clock and the
check's copy of the engine's public state.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import pathlib
import statistics
import time

import torch

from portbench import generator, plugins, trace as tracing

ROOT = pathlib.Path(__file__).resolve().parent
#: seconds of the window the profiler records in a --trace 1 run
TRACE_SECONDS = 4.0


def load_json(*parts) -> dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


@dataclasses.dataclass
class Window:
    """What the timed calls did: host times, results and lock states."""
    first: int                 # index of the first timed call
    starts: list               # perf_counter at each call's start
    ends: list                 # ... and return (every call, warm-up too)
    results: dict              # call index -> tuples it returned
    states: dict               # call index -> engine lock state after it
    drain: int                 # index of the flush() call
    seconds: float             # first timed feed -> drain and synchronize
    channel_samples: int       # channel samples a channel fed in the window
    blocks_at_start: int = 0   # the engine's block_stats before the window
    traced_blocks: int = 0     # ... and at the profiler's stop


def build_receiver(config: dict, device, timing: bool, dtype=None):
    """The configuration's receiver (config["receiver"]: "module:Class",
    its keyword arguments, and the attribute holding its locked engine)."""
    spec = config["receiver"]
    mod, cls = spec["class"].split(":")
    kwargs = dict(spec["kwargs"], device=device, timing=timing)
    if dtype is not None:
        kwargs["dtype"] = dtype
    rx = getattr(importlib.import_module(mod), cls)(**kwargs)
    engine = getattr(rx, spec["engine"]) if spec.get("engine") else rx
    return rx, engine


def drive(rx, engine, tr, warmup: int, seconds: float, state,
          profile=None):
    """Warm up with `warmup` feeds, then feed for `seconds` and flush,
    copying state(engine) after every call.  `profile`: a torch.profiler
    to run over the first TRACE_SECONDS."""
    feeds = tr.feeds
    starts, ends, results, states = [], [], {}, {}

    on_card = feeds[0].is_cuda

    def call(i, x):
        with torch.profiler.record_function(
                "portbench.drain" if x is None else "portbench.feed"):
            t0 = time.perf_counter()
            out = rx.flush() if x is None else rx.feed(x)
            if x is None and on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
        starts.append(t0)
        ends.append(t1)
        results[i] = out
        with torch.profiler.record_function("portbench.state"):
            states[i] = state(engine)

    for i in range(warmup):
        call(i, feeds[i % len(feeds)])
    if on_card:
        torch.cuda.synchronize()
    # what set-up built stays out of the window's garbage collections
    gc.collect()
    gc.freeze()
    at_start = len(engine.block_stats)
    return starts, ends, results, states, at_start, _timed(
        call, feeds, warmup, seconds, engine, profile)


def _timed(call, feeds, first, seconds, engine, profile):
    i = first
    traced = None
    if profile is not None:
        # the profiler's own start (seconds of CUPTI set-up) is set-up
        profile.start()
    t_start = time.perf_counter()
    while True:
        call(i, feeds[i % len(feeds)])
        i += 1
        now = time.perf_counter()
        if profile is not None and traced is None \
                and now - t_start >= min(TRACE_SECONDS, seconds):
            if feeds[0].is_cuda:
                torch.cuda.synchronize()
            profile.stop()
            traced = len(engine.block_stats)
        if now - t_start >= seconds:
            break
    if profile is not None and traced is None:
        if feeds[0].is_cuda:
            torch.cuda.synchronize()
        profile.stop()
        traced = len(engine.block_stats)
    call(i, None)
    return i, t_start, traced


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_process: float, limits: dict, dtype=None,
        readers=(), fault=None) -> dict:
    """One run: the result's fields (metrics by reader, device, check)."""
    tr = generator.make(config, traffic, seed, device)
    check = plugins.load("checks", limits["check"])
    rx, engine = build_receiver(config, device, timing=trace, dtype=dtype)
    undo = fault(rx, engine) if fault is not None else None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    warm = traffic["warmup_feeds"]

    try:
        starts, ends, results, states, at_start, (drain, t_win, traced) = \
            drive(rx, engine, tr, warm, seconds, check.state, prof)
    finally:
        if undo is not None:
            undo()
    t_setup_end = t_win
    win = Window(first=warm, starts=starts, ends=ends, results=results,
                 states=states, drain=drain, seconds=ends[drain] - t_win,
                 channel_samples=(drain - warm) * tr.feed_channel_samples,
                 blocks_at_start=at_start,
                 traced_blocks=at_start if traced is None else traced)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr_read = None
    if prof is not None:
        # the traced window: the first traced feed's start to the last's end
        evs = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "portbench.feed"]
        tr_read = tracing.read(prof, min(e.start_ns() for e in evs),
                               max(e.end_ns() for e in evs))
    geometry = geometry_of(config, tr, engine)
    ctx = Context(config=config, traffic=tr, window=win, trace=tr_read,
                  engine=engine, rx=rx, device=device, geometry=geometry,
                  setup_s=t_setup_end - t_process, cache={})
    metrics = {}
    for name, reader in readers:
        v = reader.read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": reader.UNIT}
    # the program's state goes before the reference runs
    del prof, ctx, rx, engine
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out = dict(metrics=metrics, memory_peak_bytes=peak,
               check=check.compare(tr, win, seed, limits, geometry, device))
    if tr_read is not None:
        out["trace"] = tr_read
    return out


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""
    config: dict
    traffic: generator.Traffic
    window: Window
    trace: object
    engine: object
    rx: object
    device: object
    geometry: dict
    setup_s: float
    cache: dict


def geometry_of(config, tr, engine) -> dict:
    adv = tr.feed_channel_samples
    # engine input after call j: a wideband receiver's first call fills its
    # filter history, so its engine runs one call behind
    lag = 1 if tr.kind == "wideband" else 0
    return dict(advance=adv, window=engine.window, lag=lag,
                channels=engine.channels, pipeline=bool(engine.pipeline),
                block_frames=engine.block_frames)


def launch_call(block: int, g: dict) -> int:
    """The call that delivered the last sample of block `block`'s window."""
    need = block * g["advance"] + g["window"]
    return -(-need // g["advance"]) - 1 + g["lag"]


def latencies_ms(win: Window, g: dict) -> list:
    """Every frame the window returned: ms from the start of the call that
    delivered its block's last sample to the return of the call that
    returned it."""
    out = []
    for i in range(win.first, win.drain + 1):
        for t in win.results[i]:
            j = min(launch_call(t[4] // g["advance"], g), i)
            out.append((win.ends[i] - win.starts[j]) * 1e3)
    return out


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) as statistics.quantiles gives it."""
    if len(values) < 2:
        return float(values[0]) if values else math.nan
    return statistics.quantiles(values, n=100, method="inclusive")[
        int(round(q * 100)) - 1]
