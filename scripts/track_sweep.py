"""Time the tracking-loop kernel (opv_tpu_torch/csrc/track_symbols.cu) on
one GPU against an older source with the same C entry point, split each
one's cycles per symbol into stages, and set them against a floor made
from the card's measured float64 latencies.

    git show b8aea75:opv_tpu_torch/csrc/track_symbols.cu > build/track_old.cu
    python scripts/track_sweep.py --baseline build/track_old.cu \
        [--out build/track_sweep.json]

The stage stamps of the baseline fit the one-warp-per-channel design of
commit b8aea75 (_WARP below).  Every library is built at once, from one
source each (one nvcc per source), under build/track_sweep/:
  build        the checkout's csrc/track_symbols.cu
  baseline     the older source
  probe / baseline probe
               copies with clock64() stamps in thread 0 between the
               stages of each symbol (window = sample loads and
               interpolation, with the new kernel's refill; sincos;
               reduction = the complex multiply-adds and the sums; tail =
               the scalar update: TED, timing loop, atan2, AFC, the LO
               increments), each stamp issued after a value of the stage
               it closes is ready, so the stages are serialised
  span / baseline span
               copies with one stamp at the loop's start and end only: the
               chain's cycles per symbol with nothing serialised
  latency      one warp timing dependent chains of each float64
               operation of the loop (add, multiply, divide, sincos,
               atan2, a 64-bit shuffle) and of each float32 one (the
               float32 loop's: __fadd_rn, __fmul_rn, __fdiv_rn, sincosf,
               atan2f, a 32-bit shuffle) with clock64(), and the SM clock
               as clock64() against %globaltimer over a ~4 ms chain
  --extra      more sources (NAME=PATH), held and timed in the turns
The SASS of build and baseline is written beside --out.
Each library is held against the plain twin on chip_smoke.track_inputs at
C = 1 and 64 (n_sym, samples_used and sym_valid equal, soft and state
within chip_smoke.TRACK_RTOL), then timed with CUDA events over
chip_smoke.TRACK_REPS launches in turns (build, baseline, build,
baseline).  Cycles per symbol: the probes' clock64 totals over each
channel's symbols (the mean over channels; the spans are the measured
critical path of each design), and each time over the symbols per
channel at the measured SM clock.  The floor: FLOOR_CHAINS' operations at
their measured latencies, the longer of the two loops, for any design of
the twin's arithmetic.  Then the float32 loop: build and span held
against the float32 twin on the same chunks as complex64 (within
chip_smoke.TRACK_F32_RTOL), build timed at float32 and float64 in turns
(float32, float64, float64, float32), span's cycles a symbol, and the
float32 floor (the same chains at the float32 latencies).  Without a CUDA
device it exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import (SPF, TRACK_CHANNELS, TRACK_REPS, cuda_ms, hold_track,  # noqa: E402
                        nvidia_smi, track_inputs)
from opv_tpu_torch.config import CONFIG  # noqa: E402
from opv_tpu_torch.ops import build  # noqa: E402
from opv_tpu_torch.ops import track_symbols as ts  # noqa: E402
from opv_tpu_torch.rx.demod import max_symbols  # noqa: E402

STAGES = ("window", "sincos", "reduction", "tail", "exchange")
#: the probe's record per channel: for threads 0 and 32, the stages, the
#: loop's span and the symbols (8 slots each)
_RECORD = 16
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
#define PROBE_START(dep) probe_t = probe_stamp(dep)
#define PROBE(q, dep) do { const long long n_ = probe_stamp(dep); \\
    probe_acc[q] += n_ - probe_t; probe_t = n_; } while (0)
""" % (_MAX_CHANNELS * _RECORD)
_PROBE_VARS = ("unsigned long long probe_acc[5] = {0, 0, 0, 0, 0};\n"
               "  long long probe_t = 0;\n"
               "  const long long probe_t0 = probe_stamp(0.0);\n")
_PROBE_OUT = """  if (threadIdx.x == 0 || threadIdx.x == 32) {
    unsigned long long* rec = opv_probe_cycles + ch * 16 + threadIdx.x / 4;
    for (int q = 0; q < 5; ++q) rec[q] = probe_acc[q];
    rec[5] = probe_stamp(static_cast<double>(k)) - probe_t0;
    rec[6] = k;
  }
"""
_PROBE_TAIL = """
extern "C" int opv_track_probe(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, opv_probe_cycles,
                                   n * sizeof(unsigned long long));
}
"""
#: (anchor after which the record is written, stage stamps: (anchor line,
#: stamp inserted after it)), per design
_CHECKOUT = (
    "  for (int j = k + tid; j < maxs; j += kThreads) {\n"
    "    soft_row[j] = R(0);\n    valid_row[j] = 0;\n  }\n",
    [("  while (run) {\n", "PROBE_START(ph1 + inc1);"),
     ("        sin_cos(add(ph2, mul(di, inc2)), &sn2, &co2);\n",
      "PROBE(1, sn1 + co1 + sn2 + co2);"),
     ("      a[j + 1] = add(w0.y, w1.y);\n    }\n",
      "PROBE(2, a[0] + a[1] + a[2] + a[3] + a[4] + a[5] + a[6] + a[7] + a[8]"
      " + a[9] + a[10] + a[11]);"),
     ("      inc2 = lo_inc(p.fd, foff, p);\n",
      "PROBE(3, inc1 + inc2 + ph1 + ph2);"),
     ("      mu = sub(t, t_int);\n", "PROBE(3, mu + pos);"),
     ("      if (next)\n        stage<R>(ring, full, seen, last_base, pos, "
      "mu, stage_tap, first, win);\n", "PROBE(0, mu + pos);"),
     ("    run = go;\n", "PROBE(4, static_cast<double>(run));")])
_WARP = (
    "  for (int j = k + lane; j < maxs; j += 32) {\n"
    "    soft_row[j] = 0.0;\n    valid_row[j] = 0;\n  }\n",
    [("  for (; k < maxs && pos < lim; ++k) {\n", "PROBE_START(foff + mu);"),
     ("    const double inc2 = __ddiv_rn(__dmul_rn(kTwoPi, __dadd_rn(p.fd, "
      "foff)), p.fs);\n", "PROBE(3, inc1 + inc2);"),
     ("        const double2 s_l = interp(w, __dadd_rn(rel, 10.0));\n",
      "PROBE(0, s_on.x + s_e.x + s_l.x);"),
     ("        sincos(__dadd_rn(ph2, __dmul_rn(di, inc2)), &sn2, &co2);\n",
      "PROBE(1, sn1 + co1 + sn2 + co2);"),
     ("        a[j] = __dadd_rn(a[j], __shfl_xor_sync(kFull, a[j], o));\n"
      "    }\n",
      "PROBE(2, a[0] + a[1] + a[2] + a[3] + a[4] + a[5] + a[6] + a[7] + a[8]"
      " + a[9] + a[10] + a[11]);"),
     ("      valid_row[k] = 1;\n    }\n",
      "PROBE(3, mu + pos + foff + ph1 + ph2);")])


_LATENCY = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kOps = 12;  // dadd, dmul, ddiv, sincos, atan2, shfl, then
                          // the same in float32
__device__ long long lat_cycles[kOps + 1];
__device__ unsigned long long lat_ns;
__device__ double lat_sink[kOps + 1];

struct Args { double y[kOps]; };

// clock64() once dep is ready: a trap on an impossible value makes the
// read wait for it
__device__ __forceinline__ long long stamp(double dep) {
  long long t;
  asm volatile("{ .reg .pred p;\n"
               "setp.eq.f64 p, %1, 0d7FEFFFFFFFFFFFFF;\n"
               "@p trap;\n"
               "mov.u64 %0, %%clock64; }"
               : "=l"(t) : "d"(dep) : "memory");
  return t;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}

template <int Op>
__device__ __forceinline__ double step(double x, double y) {
  if (Op == 0) return __dadd_rn(x, y);
  if (Op == 1) return __dmul_rn(x, y);
  if (Op == 2) return __ddiv_rn(x, y);
  if (Op == 3) {  // |x| <= 1.42 y: the loop's arguments reach ~4.8 rad
    double s, c;
    sincos(x, &s, &c);
    return __dmul_rn(__dadd_rn(s, c), y);
  }
  if (Op == 4) return atan2(x, y);
  // an add on the partner's value: a bare shuffle pair folds away
  return __dadd_rn(__shfl_xor_sync(0xffffffffu, x, 1), y);
}

template <int Op>
__device__ __forceinline__ float fstep(float x, float y) {
  if (Op == 6) return __fadd_rn(x, y);
  if (Op == 7) return __fmul_rn(x, y);
  if (Op == 8) return __fdiv_rn(x, y);
  if (Op == 9) {
    float s, c;
    sincosf(x, &s, &c);
    return __fmul_rn(__fadd_rn(s, c), y);
  }
  if (Op == 10) return atan2f(x, y);
  return __fadd_rn(__shfl_xor_sync(0xffffffffu, x, 1), y);
}

template <int Op>
__device__ void fchain(float x, float y, int n) {
  const long long t0 = stamp(x);
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = fstep<Op>(x, y);
  const long long t1 = stamp(x);
  if (threadIdx.x == 0) {
    lat_cycles[Op] = t1 - t0;
    lat_sink[Op] = x;
  }
}

template <int Op>
__device__ void chain(double x, double y, int n) {
  const long long t0 = stamp(x);
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = step<Op>(x, y);
  const long long t1 = stamp(x);
  if (threadIdx.x == 0) {
    lat_cycles[Op] = t1 - t0;
    lat_sink[Op] = x;
  }
}

__global__ void latency_kernel(double x0, Args a, int n, int clock_n) {
  chain<0>(x0, a.y[0], n);
  chain<1>(x0, a.y[1], n);
  chain<2>(x0, a.y[2], n);
  chain<3>(x0, a.y[3], n);
  chain<4>(x0, a.y[4], n);
  chain<5>(x0 + 1e-3 * threadIdx.x, a.y[5], n);  // a warp-uniform value's
  // shuffle folds away
  const float f0 = static_cast<float>(x0);
  fchain<6>(f0, static_cast<float>(a.y[6]), n);
  fchain<7>(f0, static_cast<float>(a.y[7]), n);
  fchain<8>(f0, static_cast<float>(a.y[8]), n);
  fchain<9>(f0, static_cast<float>(a.y[9]), n);
  fchain<10>(f0, static_cast<float>(a.y[10]), n);
  fchain<11>(f0 + 1e-3f * threadIdx.x, static_cast<float>(a.y[11]), n);
  double x = x0;
  const unsigned long long g0 = now_ns();
  const long long t0 = stamp(x);
  for (int i = 0; i < clock_n; ++i) x = __dadd_rn(x, a.y[0]);
  const long long t1 = stamp(x);
  const unsigned long long g1 = now_ns();
  if (threadIdx.x == 0) {
    lat_cycles[kOps] = t1 - t0;
    lat_ns = g1 - g0;
    lat_sink[kOps] = x;
  }
}

}  // namespace

// cycles: kOps + 1 host longs (each chain's n steps, then the clock
// chain's clock_n); ns: the clock chain's global-timer nanoseconds
extern "C" int opv_latency(const double* y, int n, int clock_n,
                           long long* cycles, unsigned long long* ns) {
  Args a;
  for (int i = 0; i < kOps; ++i) a.y[i] = y[i];
  latency_kernel<<<1, 32>>>(0.5, a, n, clock_n);
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(cycles, lat_cycles, sizeof(long long) * (kOps + 1));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, lat_ns, sizeof(*ns));
  return (int)e;
}
"""
#: the latency kernel's chains: name, its y (a kernel argument, so nothing
#: folds), what to subtract from a step (sincos carries an add and a
#: multiply to keep its argument in range)
_LAT_OPS = (("dadd", 1e-3, ()), ("dmul", 1.0000001, ()),
            ("ddiv", 1.0000001, ()), ("sincos", 3.3, ("dadd", "dmul")),
            ("atan2", -0.6, ()), ("shfl64", 1e-3, ("dadd",)),
            ("fadd", 1e-3, ()), ("fmul", 1.0000001, ()),
            ("fdiv", 1.0000001, ()), ("sincosf", 3.3, ("fadd", "fmul")),
            ("atan2f", -0.6, ()), ("shfl32", 1e-3, ("fadd",)))
_LAT_STEPS, _CLOCK_STEPS = 4096, 1 << 19
#: the dependent float64 operations of the twin's arithmetic from one
#: symbol's six correlator sums to the next symbol's, around each of its
#: two feedback loops.  afc: cnorm, the dominant tone times the last
#: one's conjugate, atan2, ferr (a multiply, a divide), foff, the LO
#: increment (an add, a multiply, a divide), a tap's phase, its sincos,
#: its complex product, a sum of 40 taps (6 levels).  timing: cnorm, the
#: TED (two adds, a divide), tfreq, adj, the advance and its floor, mu,
#: the next window's offset, the early tap's position, the interpolation
#: (the weights, a multiply-add), the product and the 6-level sum.
#: Floors, selects, clips and shared-memory loads are left out, so the
#: longer loop's latency is a floor under any design of that arithmetic.
FLOOR_CHAINS = {"afc": {"dmul": 7, "dadd": 12, "ddiv": 2, "sincos": 1,
                        "atan2": 1},
                "timing": {"dmul": 4, "dadd": 21, "ddiv": 1}}
#: the float32 loop's: the same chains in float32 operations
FLOOR_CHAINS_F32 = {"afc": {"fmul": 7, "fadd": 12, "fdiv": 2, "sincosf": 1,
                            "atan2f": 1},
                    "timing": {"fmul": 4, "fadd": 21, "fdiv": 1}}


def read_latency(lib) -> dict:
    """{op: cycles a dependent step}, and "sm_mhz": the SM clock that
    clock64() ran at against the global timer."""
    cycles = (ctypes.c_longlong * (len(_LAT_OPS) + 1))()
    ns = ctypes.c_ulonglong()
    ys = (ctypes.c_double * len(_LAT_OPS))(*(y for _, y, _ in _LAT_OPS))
    err = lib.opv_latency(ys, _LAT_STEPS, _CLOCK_STEPS, cycles,
                          ctypes.byref(ns))
    build.check(build.library(), err, "latency kernel")
    out = {}
    for i, (name, _, minus) in enumerate(_LAT_OPS):
        out[name] = cycles[i] / _LAT_STEPS - sum(out[m] for m in minus)
    out["sm_mhz"] = cycles[len(_LAT_OPS)] / ns.value * 1e3
    return out


def floor_cycles(lat: dict, chains=FLOOR_CHAINS) -> dict:
    """Cycles a symbol of each loop in `chains` at the latencies."""
    return {loop: sum(n * lat[op] for op, n in ops.items())
            for loop, ops in chains.items()}


def insert_after(src: str, anchor: str, text: str) -> str:
    if src.count(anchor) != 1:
        raise ValueError(f"expected one {anchor[:50]!r} in the source, found "
                         f"{src.count(anchor)}")
    return src.replace(anchor, anchor + text + "\n")


def probe_source(src: str, design, stamps: bool = True) -> str:
    """src with the probe's record (and the stage stamps of `design`, one
    of _CHECKOUT and _WARP, when `stamps`) inserted."""
    out_anchor, marks = design
    src = insert_after(src, "#include <stdint.h>\n", _PROBE_HEAD)
    src = insert_after(src, "  int k = 0;\n", "  " + _PROBE_VARS)
    src = insert_after(src, out_anchor, _PROBE_OUT)
    for anchor, stamp in marks if stamps else []:
        src = insert_after(src, anchor, stamp)
    return src + _PROBE_TAIL


def sources(baseline: pathlib.Path, extra) -> dict[str, pathlib.Path]:
    """{library name: its one source}, the copies and the latency kernel
    written under build/track_sweep/; `extra`: more (name, source) pairs,
    timed only."""
    mine = (build.CSRC / "track_symbols.cu").read_text()
    old = baseline.read_text()
    work = build.BUILD_DIR.parent / "track_sweep"
    texts = {"probe": probe_source(mine, _CHECKOUT),
             "span": probe_source(mine, _CHECKOUT, stamps=False),
             "baseline probe": probe_source(old, _WARP),
             "baseline span": probe_source(old, _WARP, stamps=False),
             "latency": _LATENCY}
    out = {"build": build.CSRC / "track_symbols.cu", "baseline": baseline,
           **dict(extra)}
    for i, (name, text) in enumerate(texts.items()):
        path = work / str(i) / ("latency.cu" if name == "latency"
                                else "track_symbols.cu")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        out[name] = path
    return out


def load_one(so: pathlib.Path) -> ctypes.CDLL:
    """A library of one source: its opv_track_symbols, probe call or
    latency call, whichever it exports."""
    lib = ctypes.CDLL(str(so))
    for name in ("opv_track_symbols", "opv_track_symbols_f32"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = build.SIGNATURES[name]
    if hasattr(lib, "opv_latency"):
        lib.opv_latency.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.opv_latency.restype = ctypes.c_int
    if hasattr(lib, "opv_track_probe"):
        lib.opv_track_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.opv_track_probe.restype = ctypes.c_int
    return lib


def build_one(srcs: dict[str, pathlib.Path]):
    """Every library at once: ({name: library}, {name: compiler log},
    {name: library path})."""
    build.library()  # the error strings, and the checkout's build log
    work = build.BUILD_DIR.parent / "track_sweep"
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


def write_sass(so: pathlib.Path, path: pathlib.Path) -> None:
    """cuobjdump's SASS of a library, for reading the loop's instructions."""
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    path.write_text(subprocess.run([str(cuobjdump), "-sass", str(so)],
                                   capture_output=True, text=True,
                                   check=True).stdout)


def ptxas_lines(log: str) -> list[str]:
    return [line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "stack frame" in line]


def runner(lib, x, nv, state, maxs):
    return lambda: ts.launch(lib, x, nv, state, CONFIG.afc_alpha, maxs)


def read_probe(lib, c: int) -> dict:
    """Cycles a symbol by stage, the mean over channels, for thread 0 and
    (where it ran the loop) thread 32."""
    buf = (ctypes.c_ulonglong * (c * _RECORD))()
    torch.cuda.synchronize()
    err = lib.opv_track_probe(ctypes.addressof(buf), c * _RECORD)
    build.check(build.library(), err, "track probe")
    rec = np.array(buf, dtype=np.float64).reshape(c, 2, _RECORD // 2)
    out = {}
    for t, who in enumerate(("thread 0", "thread 32")):
        nsym = rec[:, t, 6]
        if not nsym.all():
            continue
        row = {name: float(np.mean(rec[:, t, q] / nsym))
               for q, name in enumerate(STAGES)}
        row["span"] = float(np.mean(rec[:, t, 5] / nsym))
        row["stages_sum"] = sum(row[n] for n in STAGES)
        out[who] = row
    return out


def float32_turns(libs, dev, lat, sm_mhz, card) -> dict:
    """The float32 loop (opv_track_symbols_f32 of build and span) on the
    chunks of track_inputs as complex64, at C = 1 and TRACK_CHANNELS: held
    against the float32 twin, build timed at float32 and float64 in
    turns, span's cycles a symbol, against the float32 floor."""
    floors = floor_cycles(lat, FLOOR_CHAINS_F32)
    out = {"floor_cycles": floors, "channels": {}}
    maxs = max_symbols(SPF)
    for c in (1, TRACK_CHANNELS):
        x, nv, state = track_inputs(c, dev, torch.float32)
        x64, _, state64 = track_inputs(c, dev)
        entry = out["channels"][c] = {"held": {}}
        for name in ("build", "span"):
            (_, valid, _, _), err, _ = hold_track(
                x, nv, state, f"float32 {name} C={c}",
                run=functools.partial(ts.launch, libs[name]))
            entry["held"][name] = err
        runner(libs["span"], x, nv, state, maxs)()
        nsym = int(valid.sum()) / c
        span = read_probe(libs["span"], c)
        entry["span_cycles"] = {who: st["span"] for who, st in span.items()}
        turns = [(dt, cuda_ms(runner(libs["build"], *a, maxs), TRACK_REPS))
                 for dt, a in (("float32", (x, nv, state)),
                               ("float64", (x64, nv, state64)),
                               ("float64", (x64, nv, state64)),
                               ("float32", (x, nv, state)))]
        entry["turns"] = [[dt, ms, ms * 1e-3 * sm_mhz * 1e6 / nsym]
                          for dt, ms in turns]
        entry["floor_ms"] = max(floors.values()) * nsym / sm_mhz / 1e3
        print(f"[sweep] float32 C={c}: build and span held against the "
              f"float32 twin (soft within "
              f"{max(entry['held'].values()):.3e}); turns " + ", ".join(
                  f"{dt} {ms:.4f} ms ({cyc:.0f} cycles/symbol)"
                  for dt, ms, cyc in entry["turns"]) +
              f"; span " + ", ".join(f"{w} {v:.0f}"
                                     for w, v in entry["span_cycles"].items())
              + f" cycles/symbol; float32 floor {floors} cycles, "
              f"{entry['floor_ms']:.4f} ms ({card})", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, required=True,
                    help="an older track_symbols.cu exporting opv_track_symbols")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another track_symbols.cu to hold and time")
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/track_sweep.json"))
    args = ap.parse_args(argv)
    extra = [(e.split("=", 1)[0], pathlib.Path(e.split("=", 1)[1]))
             for e in args.extra]
    if not torch.cuda.is_available():
        raise SystemExit("track_sweep: no CUDA device")
    card = nvidia_smi("name,power.limit")
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    libs, logs, paths = build_one(sources(args.baseline, extra))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name in ("build", "baseline"):
        write_sass(paths[name], args.out.with_suffix(f".{name}.sass"))
    lat = read_latency(libs.pop("latency"))
    sm_mhz = lat["sm_mhz"]
    floors = floor_cycles(lat)
    report = {"card": card, "sm_mhz_max": max_mhz, "sm_mhz": sm_mhz,
              "reps": TRACK_REPS, "latency_cycles": lat,
              "floor_cycles": floors,
              "ptxas": {n: ptxas_lines(log) for n, log in logs.items()},
              "channels": {}}
    for name, lines in report["ptxas"].items():
        print(f"[sweep] {name}: ptxas {lines}", flush=True)
    print("[sweep] cycles a dependent step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in lat.items() if k != "sm_mhz") +
        f"; SM clock {sm_mhz:.0f} MHz measured (max {max_mhz:.0f}); floor "
        "cycles a symbol: " + ", ".join(f"{k} loop {v:.0f}"
                                        for k, v in floors.items()) +
        f" ({card})", flush=True)
    maxs = max_symbols(SPF)
    for c in (1, TRACK_CHANNELS):
        x, nv, state = track_inputs(c, dev)
        entry = report["channels"][c] = {"turns": [], "held": {}, "stages": {}}
        for name, lib in libs.items():
            (_, valid, _, _), err, _ = hold_track(
                x, nv, state, f"{name} C={c}", run=functools.partial(ts.launch, lib))
            entry["held"][name] = err
            if hasattr(lib, "opv_track_probe"):
                runner(lib, x, nv, state, maxs)()
                entry["stages"][name] = read_probe(lib, c)
        nsym = int(valid.sum()) / c
        entry["symbols_per_channel"] = nsym
        timed = [n for n in libs if "probe" not in n and "span" not in n]
        for name in ("build", "baseline", *timed[2:], "build", "baseline"):
            ms = cuda_ms(runner(libs[name], x, nv, state, maxs), TRACK_REPS)
            entry["turns"].append([name, ms, ms * 1e-3 * sm_mhz * 1e6 / nsym])
        entry["floor_ms"] = max(floors.values()) * nsym / sm_mhz / 1e3
        print(f"[sweep] C={c}: every library held against the twin (soft "
              f"within {max(entry['held'].values()):.3e}); {nsym:.0f} symbols "
              f"a channel; turns " + ", ".join(
                  f"{n} {ms:.4f} ms ({cyc:.0f} cycles/symbol as ms x "
                  f"{sm_mhz:.0f} MHz)" for n, ms, cyc in entry["turns"]) +
              f"; floor {entry['floor_ms']:.4f} ms ({card})", flush=True)
        for name, per in entry["stages"].items():
            for who, st in per.items():
                print(f"[sweep] C={c} {name} {who}: cycles/symbol " + ", ".join(
                    f"{k} {v:.0f}" for k, v in st.items()), flush=True)
    report["float32"] = float32_turns(libs, dev, lat, sm_mhz, card)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[sweep] wrote {args.out} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
