"""Time the sync state machine kernel (opv_tpu_torch/csrc/sync_scan.cu) on
one GPU against an older source with the same C entry point, and count
its clock64() cycles a tile.

    git show 2dbd49d:opv_tpu_torch/csrc/sync_scan.cu > build/sync_old.cu
    python scripts/sync_sweep.py --baseline build/sync_old.cu \
        [--extra NAME=PATH ...] [--out build/sync_sweep.json]

Every library is built at once, from one source each (one nvcc per
source), under build/sync_sweep/:
  build        the checkout's csrc/sync_scan.cu
  baseline     the older source (opv_sync_scan only: raw and norm given)
  --extra      more sources with both C entry points (NAME=PATH), held
               and timed in the turns beside build
  probe        a copy of build with clock64() stamps in lane 0 of each
               warp: the kernel's walk from the carry's load to its store
               (span), and inside it the input stage (prepare: the loads'
               wait, and for SoftSync the correlation; each stamp waits for
               a value of the stage it closes) and the walk of the tiles
  baseline probe
               the older source with stamps around its symbol loop (span)
Each library is held bit for bit against the plain twins on one chunk of
the golden mix (chip_smoke.track_inputs, T1's soft from a zero history)
at C = 1 and 64 and on the stress inputs, then timed with CUDA events over
chip_smoke.SYNC_REPS launches queued behind a sleep (chip_smoke.device_ms)
in turns: build, baseline, build, baseline
on given raw/norm (GivenSync); build's SoftSync against baseline after
torch's sync_correlate (the route it replaces).  The SASS of build and
baseline is written beside --out.  Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import pathlib
import re
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from chip_smoke import (SPF, SYNC_REPS, TRACK_CHANNELS,  # noqa: E402
                        device_ms, hold_sync, hold_sync_soft,
                        nvidia_smi, soft_stress, track_inputs)
from opv_tpu_torch.config import CONFIG  # noqa: E402
from opv_tpu_torch.ops import build  # noqa: E402
from opv_tpu_torch.ops import sync_scan as sc  # noqa: E402
from opv_tpu_torch.ops import track_symbols as ts  # noqa: E402
from opv_tpu_torch.rx.demod import max_symbols  # noqa: E402
from opv_tpu_torch.rx.sync import sync_correlate  # noqa: E402
from track_sweep import insert_after, ptxas_lines, write_sass  # noqa: E402

#: the probe's record per channel: prepare, walk, span, tiles
_RECORD = 4
_MAX_CHANNELS = 256

_PROBE_HEAD = """
__device__ unsigned long long opv_probe_cycles[%d];
__device__ __forceinline__ long long probe_stamp(double dep) {
  long long t;
  asm volatile("{ .reg .pred p;\\n"
               "setp.eq.f64 p, %%1, 0d7FEFFFFFFFFFFFFF;\\n"
               "@p trap;\\n"
               "mov.u64 %%0, %%%%clock64; }"
               : "=l"(t) : "d"(dep) : "memory");
  return t;
}
""" % (_MAX_CHANNELS * _RECORD)
_PROBE_TAIL = """
extern "C" int opv_sync_probe(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, opv_probe_cycles,
                                   n * sizeof(unsigned long long));
}
"""
#: (anchor, text inserted after it) of the new kernel's probe
_NEW_MARKS = (
    ("  c.sq = q_in[ch];\n",
     "  unsigned long long probe_acc[2] = {0, 0};\n"
     "  const long long probe_t0 = probe_stamp(c.sq);\n"
     "  long long probe_t = probe_t0;"),
    ("    in.prepare(cur, r, n, buf, row, t0, steps, lane);\n",
     "    { const long long n_ = probe_stamp(r[0] + n[0]);\n"
     "      probe_acc[0] += n_ - probe_t; probe_t = n_; }"),
    ("        ev_frames[at] = o.frames;\n      }\n    }\n",
     "    { const long long n_ = probe_stamp(static_cast<double>(c.sss));\n"
     "      probe_acc[1] += n_ - probe_t; probe_t = n_; }"),
    ("  if (lane == 0) {\n    int* so = ist_out + ch * kIntWidth;\n",
     "    unsigned long long* rec = opv_probe_cycles + ch * 4;\n"
     "    rec[0] = probe_acc[0]; rec[1] = probe_acc[1];\n"
     "    rec[2] = probe_stamp(static_cast<double>(c.sss)) - probe_t0;\n"
     "    rec[3] = (steps + 31) / 32;"),
)
#: ... and of the older kernel (a thread per channel): the loop's span
_OLD_MARKS = (
    ("  const long long row = static_cast<long long>(ch) * steps;\n",
     "  const long long probe_t0 = probe_stamp(sq);"),
    ("  int* so = ist_out + ch * kIntWidth;\n",
     "  { unsigned long long* rec = opv_probe_cycles + ch * 4;\n"
     "    rec[0] = 0; rec[1] = 0;\n"
     "    rec[2] = probe_stamp(static_cast<double>(sss)) - probe_t0;\n"
     "    rec[3] = (steps + 31) / 32; }"),
)

def probe_source(src: str, marks) -> str:
    src = insert_after(src, "#include <stdint.h>\n", _PROBE_HEAD)
    for anchor, text in marks:
        src = insert_after(src, anchor, text)
    return src + _PROBE_TAIL


def sources(baseline: pathlib.Path, extra) -> dict[str, pathlib.Path]:
    """{library name: its one source}, copies written under
    build/sync_sweep/; `extra`: more (name, source) pairs."""
    mine = (build.CSRC / "sync_scan.cu").read_text()
    old = baseline.read_text()
    work = build.BUILD_DIR.parent / "sync_sweep"
    texts = {"probe": probe_source(mine, _NEW_MARKS),
             "baseline probe": probe_source(old, _OLD_MARKS)}
    out = {"build": build.CSRC / "sync_scan.cu", "baseline": baseline,
           **dict(extra)}
    for i, (name, text) in enumerate(texts.items()):
        path = work / str(i) / "sync_scan.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out[name] = path
    return out


def load_one(so: pathlib.Path) -> ctypes.CDLL:
    """A library of one source, its exported calls declared."""
    lib = ctypes.CDLL(str(so))
    for name in ("opv_sync_scan", "opv_sync_correlate_scan"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = build.SIGNATURES[name]
    if hasattr(lib, "opv_sync_probe"):
        lib.opv_sync_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.opv_sync_probe.restype = ctypes.c_int
    return lib


def build_all(srcs: dict[str, pathlib.Path]):
    """Every library at once: ({name: library}, {name: compiler log},
    {name: library path})."""
    build.library()  # the error strings, and the checkout's build log
    work = build.BUILD_DIR.parent / "sync_sweep"
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        futs = {}
        for name, path in srcs.items():
            tag = re.sub(r"\W", "_", name)
            so = work / f"lib_{tag}_{build.library_path([path]).stem[-16:]}.so"
            futs[name] = (so, pool.submit(build.compile_shared, [path], so))
        libs, logs, paths = {}, {}, {}
        for name, (so, fut) in futs.items():
            fut.result()
            libs[name] = load_one(so)
            logs[name] = so.with_suffix(".log").read_text()
            paths[name] = so
    return libs, logs, paths


def read_probe(lib, c: int) -> dict:
    """Cycles a tile (the mean over channels): prepare, walk, span."""
    buf = (ctypes.c_ulonglong * (c * _RECORD))()
    torch.cuda.synchronize()
    err = lib.opv_sync_probe(ctypes.addressof(buf), c * _RECORD)
    build.check(build.library(), err, "sync probe")
    rec = np.array(buf, dtype=np.float64).reshape(c, _RECORD)
    tiles = rec[:, 3]
    return {name: float(np.mean(rec[:, q] / tiles))
            for q, name in enumerate(("prepare", "walk", "span"))}


def golden_chunk(c: int, dev):
    """T1's soft for one chunk of the golden mix at c channels as
    rx_block_from_soft hands it over from a zero history: (soft_ext view,
    valid, ints, q)."""
    eb = CONFIG.encoded_bits
    x, nv, state = track_inputs(c, dev)
    soft, valid, _, _ = ts.track_symbols_cuda(x, nv, state, CONFIG.afc_alpha,
                                              max_symbols(SPF))
    ext = torch.cat([torch.zeros((c, eb), dtype=torch.float64, device=dev),
                     soft], 1)[:, eb - 23:]
    return (ext, valid, torch.zeros((c, 6), dtype=torch.int32, device=dev),
            torch.zeros(c, dtype=torch.float64, device=dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, required=True,
                    help="an older sync_scan.cu exporting opv_sync_scan")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another sync_scan.cu (both entry points) to hold "
                         "and time")
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/sync_sweep.json"))
    args = ap.parse_args(argv)
    extra = [(e.split("=", 1)[0], pathlib.Path(e.split("=", 1)[1]))
             for e in args.extra]
    if not torch.cuda.is_available():
        raise SystemExit("sync_sweep: no CUDA device")
    card = nvidia_smi("name,power.limit")
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    libs, logs, paths = build_all(sources(args.baseline, extra))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name in ("build", "baseline"):
        write_sass(paths[name], args.out.with_suffix(f".{name}.sass"))
    report = {"card": card, "sm_mhz_max": max_mhz, "reps": SYNC_REPS,
              "ptxas": {n: ptxas_lines(log) for n, log in logs.items()},
              "cases": {}}
    for name, lines in report["ptxas"].items():
        print(f"[sweep] {name}: ptxas {lines}", flush=True)

    new, old = libs["build"], libs["baseline"]
    given = {n: functools.partial(sc.launch, lib) for n, lib in libs.items()}
    cases = {f"golden C={c}": functools.partial(golden_chunk, c)
             for c in (1, TRACK_CHANNELS)}
    cases["stress"] = lambda d: soft_stress(TRACK_CHANNELS, max_symbols(SPF), d)
    for case, make in cases.items():
        ext, valid, ints, q = make(dev)
        c, steps = valid.shape
        entry = report["cases"][case] = {"channels": c, "symbols": steps,
                                         "turns": [], "cycles_a_tile": {}}
        got, _ = hold_sync_soft(ext, valid, ints, q, f"build {case}",
                                run=functools.partial(sc.launch_soft, new))
        for name, _ in extra:
            hold_sync_soft(ext, valid, ints, q, f"{name} {case}",
                           run=functools.partial(sc.launch_soft, libs[name]))
        raw, norm = got[7], got[8]
        for name, run in given.items():
            hold_sync(raw, norm, valid, ints, q, f"{name} {case}", run=run)
        hold_sync_soft(ext, valid, ints, q, f"probe {case}",
                       run=functools.partial(sc.launch_soft, libs["probe"]))
        entry["cycles_a_tile"]["SoftSync"] = read_probe(libs["probe"], c)
        given["probe"](raw, norm, valid, ints, q)
        entry["cycles_a_tile"]["GivenSync"] = read_probe(libs["probe"], c)
        given["baseline probe"](raw, norm, valid, ints, q)
        entry["cycles_a_tile"]["baseline"] = read_probe(libs["baseline probe"],
                                                        c)
        runs = {"GivenSync": functools.partial(sc.launch, new, raw, norm,
                                               valid, ints, q),
                "baseline": functools.partial(sc.launch, old, raw, norm,
                                              valid, ints, q),
                "SoftSync": functools.partial(sc.launch_soft, new, ext,
                                              valid, ints, q),
                "baseline + sync_correlate": lambda: sc.launch(
                    old, *sync_correlate(ext), valid, ints, q)}
        for name, _ in extra:
            runs[f"{name} GivenSync"] = functools.partial(
                sc.launch, libs[name], raw, norm, valid, ints, q)
            runs[f"{name} SoftSync"] = functools.partial(
                sc.launch_soft, libs[name], ext, valid, ints, q)
        order = list(runs)
        for name in order + order:
            entry["turns"].append([name, device_ms(runs[name], SYNC_REPS)])
        ev = np.bincount(got[4].cpu().numpy().ravel(), minlength=6).tolist()
        print(f"[sweep] {case} ({c} x {steps}, events by code {ev}): every "
              f"library bit-identical to the twins; turns " + ", ".join(
                  f"{n} {ms:.4f} ms" for n, ms in entry["turns"]) +
              f"; clock64 cycles a tile " + "; ".join(
                  f"{k}: " + ", ".join(f"{s} {v:.0f}" for s, v in d.items())
                  for k, d in entry["cycles_a_tile"].items()) + f" ({card})",
              flush=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[sweep] wrote {args.out} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
