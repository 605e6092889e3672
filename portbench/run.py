"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python -m portbench.run --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

BENCHMARK.json (the checkout's root) names the cell's configuration
(portbench/configs/<config>.json), its traffic mix
(portbench/traffic/<traffic>.json) and its metrics, each read by
portbench/metrics/<metric>.py; portbench/limits/<workload>.json names the
cell's check (portbench/checks/<check>.py) and the limits of the numbers
that decide `correct`.  --trace 0 reports the
cell's end-to-end metrics, --trace 1 its per-layer ones from a
torch.profiler trace of the window's first seconds.  The run needs as many
CUDA devices as the cell asks for, and exits non-zero without a result
where they are missing, or where jax, jaxlib, flax or opv_tpu (compared by
whole top-level module names) is loaded once the window has closed.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The process's start on the perf_counter clock (Linux: its start
    time since boot, 10 ms resolution); this module's import elsewhere."""
    import os
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "opv_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def caches() -> None:
    """Every compiler cache in fixed directories of the checkout (the
    program builds its kernels under build/ of its own)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CHECKOUT / "build" / "portbench" / sub)
    os.environ["USE_FLAX"] = "0"


def reader(name: str):
    """portbench/metrics/<name>.py as a module."""
    from portbench import plugins
    return plugins.load("metrics", name)


def cell_of(bench: dict, workload: str):
    """(workload entry, config entry) of a cell of BENCHMARK.json."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            conf = next(c for c in bench["configs"]
                        if c["name"] == w["config"])
            return w, conf
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The names of the metrics a run of `workload` reports: the end-to-end
    ones without --trace, the per-layer ones with it.  A per-layer metric
    lists its cells under `workloads`; an end-to-end one is every cell's
    unless it lists them there too."""
    if not trace:
        return [m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m["name"] for m in bench["per_layer"]
            if workload in m["workloads"]]


def result_line(res: dict, device: dict) -> dict:
    """The last line of standard output: the driver's keys, the numbers
    compared (each beside its limit) last."""
    check = res["check"]
    trace = res.get("trace")
    out = dict(correct=check["correct"], attempted=check["attempted"],
               failed=check["failed"], metrics=res["metrics"], device=device)
    if trace is not None:
        out["breakdown"] = {"device_ops": [list(x) for x in trace.device_ops],
                            "idle_gaps": [list(x) for x in trace.idle_gaps]}
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in check["numbers"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches()
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    work, conf = cell_of(bench, args.workload)

    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < work["chips"]:
        log(f"{args.workload} needs {work['chips']} CUDA device(s); "
            f"found {cards}")
        return 2
    from portbench import cell
    config = json.loads((CHECKOUT / conf["file"]).read_text())
    traffic = cell.load_json("traffic", f"{work['traffic']}.json")
    limits = cell.load_json("limits", f"{args.workload}.json")
    names = metrics_of(bench, args.workload, bool(args.trace))
    readers = [(n, reader(n)) for n in names]
    res = cell.run(config, traffic, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_PROCESS, limits,
                   readers=readers)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if found:
        log(f"loaded in the measuring process: {found}")
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=work["chips"],
                  memory_peak_bytes=res["memory_peak_bytes"])
    tr = res.get("trace")
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
    line = result_line(res, device)
    check = res["check"]
    log(f"compared {check['compared']} of {check['eligible']} eligible "
        f"frames; largest sync-quality gap {check['sync_q_gap']:.3e}")
    log(f"estimate errors (10/50/90th percentiles): {check['estimates']}")
    for f in check["corrupt_frames"]:
        log(f"wrong frame: {f}")
    if check["missed_by_channel"]:
        log(f"missed frames by channel: {check['missed_by_channel']}")
    if tr is not None:
        log(f"traced {tr.window_s:.3f} s, device busy {tr.busy_s:.3f} s")
    for k, (v, lim) in check["numbers"].items():
        log(f"{k} {v} limit {lim}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
