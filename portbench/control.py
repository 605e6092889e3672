"""Readings for the limits of `correct`: the program on sound runs over
many seeds, its lower-precision path (the configuration's "control") and
planted faults, all at the cell's own size, in one process.

    python -m portbench.control --workload <name> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...] [--faults <name> ...]

Each run prints one JSON line on standard output: what ran, its seed and
every number compared, beside the limit the cell has now.  The benchmark's
runs never run this."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import cell, faults, run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(faults.FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench_run.caches()
    bench = json.loads((bench_run.CHECKOUT / "BENCHMARK.json").read_text())
    work, conf = bench_run.cell_of(bench, args.workload)
    import torch
    config = json.loads((bench_run.CHECKOUT / conf["file"]).read_text())
    traffic = cell.load_json("traffic", f"{work['traffic']}.json")
    limits = cell.load_json("limits", f"{args.workload}.json")
    plan = [("program", s, None, None) for s in args.seeds]
    plan += [("control", s, config["control"]["dtype"], None)
             for s in args.control_seeds]
    plan += [(f, s, None, faults.FAULTS[f]) for f in args.faults
             for s in (args.fault_seeds or args.seeds[:3])]
    for what, seed, dtype, fault in plan:
        t0 = time.perf_counter()
        res = cell.run(config, traffic, seed, args.seconds, False,
                       args.device, t0, limits, dtype=dtype, fault=fault)
        chk = res["check"]
        print(json.dumps(dict(
            workload=args.workload, run=what, seed=seed,
            correct=chk["correct"], compared=chk["compared"],
            numbers={k: v for k, (v, _) in chk["numbers"].items()},
            limits={k: lim for k, (_, lim) in chk["numbers"].items()},
            sync_q_gap=chk["sync_q_gap"], estimates=chk["estimates"],
            seconds=round(time.perf_counter() - t0, 1))), flush=True)
        del res
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
