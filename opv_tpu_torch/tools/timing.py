"""Timing, rooflines and the record header shared by the measurement tools
(stage_bench, tx_bench, wideband_bench, modem_bench, scaling_bench) and
chip_smoke.py.

Device time comes from CUDA events around many launches after a warm-up
(clock "cuda_events"); a host clock is read only around work that ends in
torch.cuda.synchronize() (clock "host").  Every figure is taken over
WINDOWS windows and reported as its median with the min and max.  On the
CPU nothing is timed: a tool runs each measured function once, for its
checks, and writes NOT_MEASURED where the figure would stand."""

from __future__ import annotations

import pathlib
import statistics
import subprocess
import time

import torch

#: published H100 SXM peaks (NVIDIA's H100 datasheet, dense, at 700 W):
#: HBM bytes/s, and operations/s for float32 and float64 outside the tensor
#: cores, int8 on them, and float64 on them (a DGEMM)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12, "f64": 34e12,
                  "f64_tensor": 67e12}
WINDOWS = 5
NOT_MEASURED = "not measured"
#: the slowest SM clock torch.cuda._sleep's cycles are converted at: a
#: slower card sleeps longer, which only queues more launches
_SLEEP_HZ = 2.0e9
#: doublings of that sleep before a queued window gives up
MAX_QUEUE_RETRIES = 6
#: int32 operations of the Viterbi per trellis state per step (two adds, a
#: compare and a select) and per step shared by the 64 states (the four
#: branch metrics of a rate-1/2 code)
VITERBI_OPS_PER_STATE_STEP = 4
VITERBI_OPS_PER_STEP = 4


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def int32_ops_per_s() -> float:
    """The card's int32 issue rate: 64 lanes per SM at the max SM clock."""
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * sm_mhz * 1e6


def bound(nbytes: float, nops: float, ops_per_s: float):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate
    and operations over the peak rate for their type."""
    return bound_of(nbytes, [(nops, ops_per_s)])


def bound_of(nbytes: float, work):
    """bound() for work of several types: `work` is [(operations, their
    peak rate)], whose times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for n, rate in work)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def viterbi_work(b: int):
    """(bytes, int32 operations) of the Viterbi over B frames: each soft
    value read once (int32), each bit and metric written once, and every
    state's add-compare-select at every trellis step."""
    eb, fb = 2144, 1072
    return (b * (eb * 4 + fb + 4),
            b * fb * (64 * VITERBI_OPS_PER_STATE_STEP + VITERBI_OPS_PER_STEP))


def roofline(nbytes: float, work, timing: dict) -> dict:
    """The roofline record of a timed stage: bytes, operations, the bound
    and its share of the stage's median; off the card (no timing, and
    rates that may be None) the bound and share are NOT_MEASURED."""
    rec = dict(bytes=int(nbytes), ops=int(sum(n for n, _ in work)))
    if "median_ms" not in timing:
        return dict(rec, bound_ms=NOT_MEASURED, bound_by=NOT_MEASURED,
                    share=NOT_MEASURED)
    bound_ms, by = bound_of(nbytes, work)
    return dict(rec, bound_ms=bound_ms, bound_by=by,
                share=bound_ms / timing["median_ms"])


def spread(values) -> dict:
    return dict(median=statistics.median(values), min=min(values),
                max=max(values))


def event_windows(fn, calls: int, windows: int = WINDOWS,
                  queue: bool = False) -> dict:
    """Device ms per call of fn(): `calls` calls between two CUDA events,
    in `windows` windows after a warm-up window.  queue: a sleep kernel
    holds the device while the host enqueues the window, so the window
    times the device alone (a stage whose launches cost the host more
    than the device); it is lengthened until the start event is still
    pending when the last call is queued, and a function that waits on
    the device (which defeats the queue) raises."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    cycles = 0
    if queue:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        cycles = int((2 * (time.perf_counter() - t0) + 0.002) * _SLEEP_HZ)
        torch.cuda.synchronize()
    per_call, retries = [], 0
    while len(per_call) < windows:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queue:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        drained = queue and start.query()
        torch.cuda.synchronize()
        if drained:
            retries += 1
            if retries > MAX_QUEUE_RETRIES:
                raise RuntimeError(f"{fn}: the device drained its queue "
                                   f"{retries} times; does it wait on the "
                                   "device?")
            cycles *= 2
            continue
        per_call.append(start.elapsed_time(end) / calls)
    return dict(clock="cuda_events", **{f"{k}_ms": v for k, v in
                                        spread(per_call).items()},
                windows=windows, calls_per_window=calls, queued=queue,
                window_ms=per_call)


def host_windows(fn, windows: int = WINDOWS) -> dict:
    """Host seconds of fn() in each of `windows` windows, each window
    ending in torch.cuda.synchronize() (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    secs = []
    for _ in range(windows):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return dict(clock="host", **{f"{k}_ms": v * 1e3 for k, v in
                                 spread(secs).items()},
                windows=windows, window_ms=[s * 1e3 for s in secs])


def measures(dev) -> bool:
    """Whether figures are taken on `dev`: only on a CUDA device."""
    return torch.device(dev).type == "cuda"


def timed(fn, dev, calls: int = 1, windows: int = WINDOWS,
          clock: str = "cuda_events", queue: bool = False) -> dict:
    """fn() timed on the card by `clock` ("cuda_events": ms per call;
    "host": ms per window of one call); on the CPU fn() runs once, untimed,
    and the record says NOT_MEASURED."""
    if not measures(dev):
        fn()
        return dict(clock=NOT_MEASURED)
    if clock == "host":
        return host_windows(fn, windows)
    return event_windows(fn, calls, windows, queue)


def rate(units: float, timing: dict, scale: float = 1e-6):
    """units per second x scale from a timing's median, with the spread
    (the min from the slowest window); NOT_MEASURED off the card."""
    if "median_ms" not in timing:
        return NOT_MEASURED
    per_s = {k: units / (timing[f"{t}_ms"] * 1e-3) * scale
             for k, t in (("median", "median"), ("min", "max"),
                          ("max", "min"))}
    return per_s


def commit() -> str | None:
    """The checkout's commit, where it is a git checkout."""
    root = pathlib.Path(__file__).resolve().parents[2]
    try:
        r = subprocess.run(["git", "-C", str(root), "rev-parse", "HEAD"],
                           capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def header(tool: str, argv, dev, commit_label: str | None = None) -> dict:
    """What every record of a tool starts with: the tool, its command, the
    device type, the card's name and power limit (nvidia-smi's), the
    device count, the commit, and on the card the peaks its rooflines
    use."""
    from opv_tpu_torch.tools.capture import card_name
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    out = dict(tool=tool,
               command=" ".join(["python -m", f"opv_tpu_torch.tools.{tool}",
                                 *map(str, argv)]),
               device=dev.type, card=card_name() if on_card else None,
               device_count=(torch.cuda.device_count()
                             if torch.cuda.is_available() else 0),
               commit=commit_label or commit())
    if on_card:
        out["peaks"] = dict(hbm_bytes_per_s=HBM_BYTES_PER_S,
                            ops_per_s=dict(PEAK_OPS_PER_S,
                                           int32=int32_ops_per_s()))
    return out
