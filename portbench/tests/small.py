"""Tiny versions of the benchmark's cells for the CPU tests: the same
configuration and traffic files, cut to a few channels and a short noise
period, run on the program's plain twins."""

from __future__ import annotations

import json
import time

from portbench import cell, run as bench_run

ROOT = bench_run.CHECKOUT


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cut(workload: str, channels: int):
    """(config, traffic, limits) of `workload` at `channels` channels."""
    work, conf = bench_run.cell_of(bench(), workload)
    config = json.loads((ROOT / conf["file"]).read_text())
    key = "k" if config["input"]["kind"] == "wideband" else "channels"
    config["input"][key] = channels
    config["receiver"]["kwargs"][key] = channels
    config["engine"]["channels"] = channels
    traffic = cell.load_json("traffic", f"{work['traffic']}.json")
    traffic.pop("noise_frames", None)
    traffic.pop("cycle_frames", None)
    limits = cell.load_json("limits", f"{workload}.json")
    return config, traffic, limits


def run(workload: str, channels: int, seconds: float, seed: int,
        readers=(), **kw) -> dict:
    config, traffic, limits = cut(workload, channels)
    return cell.run(config, traffic, seed, seconds, False, "cpu",
                    time.perf_counter(), limits, readers=readers, **kw)
