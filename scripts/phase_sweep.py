"""Time the exact TX's phase recurrence (opv_tpu_torch/csrc/phase_track.cu,
a walk over binade segments) on one GPU against an older source of the
serial design, split the walk's cycles a segment into stages, and give the
floor of its dependent chain from the card's measured latencies.

    git show 9eeeff3:opv_tpu_torch/csrc/phase_track.cu > build/phase_old.cu
    python scripts/phase_sweep.py --baseline build/phase_old.cu \
        [--extra NAME=PATH ...] [--out build/phase_sweep.json]

Every library is built at once, from one source each (one nvcc per
source), under build/phase_sweep/:
  build      the checkout's csrc/phase_track.cu: the walk launch, then the
             grid's fill launch
  probe      a copy with clock64() stamps in the walk thread between the
             stages of each segment (decode: x's table entry and
             p = x + inc; count: the room, the floor of the count and the
             segment's last phase; step: the real step across the edge and
             the count's bookkeeping), each issued after a value of the
             stage it closes is ready, so the stages are serialised
  span       a copy with one stamp at the walk loop's start and end, and
             the global timer beside them: the walk's cycles a segment with
             nothing serialised, its time, and the SM clock
  latency    one thread timing dependent chains of the walk's operations
             (dadd, dfma, frnd, a compare and select on a float or an
             integer predicate, the table's decode and shared-memory load,
             f2i and i2f, ddiv) and the serial recurrence's whole step
             (the add, then both wraps) with clock64()
  baseline   the older source (its C entry takes no scratch: the serial
             kernel, one thread a tone walking every sample)
  --extra    more sources with the checkout's C entry (NAME=PATH), held
             and timed beside build
Each library is held bit for bit against the twin at the main path's
shape (bert3: 3 frames x 2 tones from reset), the build's segment tables
against the CPU model's, then each is timed with CUDA events over REPS
launches in turns (build, baseline, the extras, then the same backwards).
The floor: each tone's segments times the latencies of the walk's
dependent chain a segment (FLOOR_CHAIN), at the SM clock the span
measured, the longer tone; the serial kernel's: n steps of wrap_step.
The SASS of build and of each extra is written
beside --out.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from chip_smoke import cuda_ms  # noqa: E402
from opv_tpu_torch.config import CONFIG  # noqa: E402
from opv_tpu_torch.ops import build  # noqa: E402
from opv_tpu_torch.ops import phase_track as pt  # noqa: E402
from opv_tpu_torch.tools.timing import nvidia_smi  # noqa: E402
from opv_tpu_torch.tx.modulator import _INC1, _INC2  # noqa: E402
from track_sweep import (floor_cycles, insert_after, ptxas_lines,  # noqa: E402
                         write_sass)

FRAMES = 3
REPS = 20
STAGES = ("decode", "count", "step")
_SOURCE = "phase_track.cu"
#: the walk's dependent chain a segment, from x to the next segment's x:
#: decode (the exponent's shift and the table's shared-memory load, beside
#: p = x + inc), room (a dadd), the count's fma and its read (a dadd), the
#: segment's last phase (a dfma), the real step and its wrap (two dadds).
#: Selects and the loop's bookkeeping are left out: a floor under the walk
FLOOR_CHAIN = {"shf_lop_lds": 1, "dadd": 4, "dfma": 2}

_PROBE_HEAD = r"""
__device__ unsigned long long opv_phase_probe_rec[2][6];
// clock64() once dep is ready: a trap on an impossible value makes the
// read wait for it
__device__ __forceinline__ long long probe_stamp(double dep) {
  long long t;
  asm volatile("{ .reg .pred p;\n"
               "setp.eq.f64 p, %1, 0d7FEFFFFFFFFFFFFF;\n"
               "@p trap;\n"
               "mov.u64 %0, %%clock64; }"
               : "=l"(t) : "d"(dep) : "memory");
  return t;
}
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}"""
#: (anchor in csrc/phase_track.cu, text inserted after it): the span's
#: stamps and record, then the stages' stamps
_SPAN_MARKS = (
    ("  double fin = x;\n",
     "  unsigned long long probe_acc[3] = {0, 0, 0};\n"
     "  long long probe_t = 0;\n"
     "  const unsigned long long probe_g0 = probe_ns();\n"
     "  const long long probe_t0 = probe_stamp(x);"),
    ("  const long long ns = sp - seg;\n",
     "  { const long long t1_ = probe_stamp(fin);\n"
     "    const unsigned long long g1_ = probe_ns();\n"
     "    unsigned long long* rec_ = opv_phase_probe_rec[blockIdx.x];\n"
     "    for (int q_ = 0; q_ < 3; ++q_) rec_[q_] = probe_acc[q_];\n"
     "    rec_[3] = t1_ - probe_t0; rec_[4] = g1_ - probe_g0; rec_[5] = ns;\n"
     "    (void)probe_t; }"),
)
_STAGE_MARKS = (
    ("    for (;;) {\n", "      probe_t = probe_stamp(x);"),
    ("      const double wp = wrap(p);  // the next phase if no step of d is taken\n",
     "      { const long long n_ = probe_stamp(t.b + t.rc + t.d + t.wrap + p);\n"
     "        probe_acc[0] += n_ - probe_t; probe_t = n_; }"),
    ("                    ? static_cast<int>(est_lo) + 1 : k_big;\n",
     "      { const long long n_ = probe_stamp(x_end);\n"
     "        probe_acc[1] += n_ - probe_t; probe_t = n_; }"),
    ("      rest -= k + 1;\n",
     "      { const long long n_ = probe_stamp(x);\n"
     "        probe_acc[2] += n_ - probe_t; probe_t = n_; }"),
)
_PROBE_TAIL = """
extern "C" int opv_phase_probe(void* host) {
  return (int)cudaMemcpyFromSymbol(host, opv_phase_probe_rec,
                                   sizeof(opv_phase_probe_rec));
}
"""
_LATENCY = r"""
#include <cuda_runtime.h>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kTwoPi = 2.0 * kPi;
constexpr int kOps = 9;
__device__ long long lat_cycles[kOps + 1];
__device__ unsigned long long lat_ns;
__device__ double lat_sink[kOps + 1];

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

// One dependent step of op Op on x; y and z are kernel arguments (nothing
// folds); tab: eight copies of x0 in shared memory.
template <int Op>
__device__ __forceinline__ double step(double x, double y, double z, const double* tab) {
  if (Op == 0) return __dadd_rn(x, y);                       // dadd
  if (Op == 1) return __fma_rn(x, y, z);                     // dfma
  if (Op == 2) return __dadd_rn(rint(x), y);                 // frnd + dadd
  if (Op == 3) {                                             // dadd + dsetp + fsel
    const double a = __dadd_rn(x, y), b = __dsub_rn(a, z);
    return a > z ? b : a;
  }
  if (Op == 4) {                                             // dadd + isetp + fsel
    const double a = __dadd_rn(x, y), b = __dsub_rn(a, z);
    return __double2hiint(a) < 0 ? b : a;
  }
  if (Op == 5)                                               // shf + lop + lds
    return tab[(static_cast<unsigned>(__double2hiint(x)) >> 20) & 7];
  if (Op == 6)                                               // f2i + i2f + dadd
    return __dadd_rn(static_cast<double>(__double2ll_rn(x)), y);
  if (Op == 7) return __dadd_rn(__ddiv_rn(x, z), y);         // ddiv + dadd
  double p = x + y;  // the serial recurrence's step: the add, both wraps
  if (p > kPi) p -= kTwoPi;
  if (p < -kPi) p += kTwoPi;
  return p;
}

template <int Op>
__device__ void chain(double x, double y, double z, const double* tab, int n) {
  const long long t0 = stamp(x);
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = step<Op>(x, y, z, tab);
  const long long t1 = stamp(x);
  lat_cycles[Op] = t1 - t0;
  lat_sink[Op] = x;
}

__global__ void latency_kernel(double x0, double y, double z, int n, int clock_n) {
  __shared__ double tab[8];
  if (threadIdx.x < 8) tab[threadIdx.x] = x0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  chain<0>(x0, y, z, tab, n);
  chain<1>(x0, y, z, tab, n);
  chain<2>(x0, y, z, tab, n);
  chain<3>(x0, y, z, tab, n);
  chain<4>(x0, y, z, tab, n);
  chain<5>(x0, y, z, tab, n);
  chain<6>(x0, y, z, tab, n);
  chain<7>(x0, y, z, tab, n);
  chain<8>(x0, y, z, tab, n);
  double x = x0;
  const unsigned long long g0 = now_ns();
  const long long t0 = stamp(x);
  for (int i = 0; i < clock_n; ++i) x = __dadd_rn(x, y);
  const long long t1 = stamp(x);
  const unsigned long long g1 = now_ns();
  lat_cycles[kOps] = t1 - t0;
  lat_ns = g1 - g0;
  lat_sink[kOps] = x;
}

}  // namespace

extern "C" int opv_phase_latency(int n, int clock_n, long long* cycles,
                                 unsigned long long* ns) {
  latency_kernel<<<1, 32>>>(0.5, 1e-3, 1.0000001, n, clock_n);
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(cycles, lat_cycles, sizeof(long long) * (kOps + 1));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, lat_ns, sizeof(*ns));
  return (int)e;
}
"""
#: the latency kernel's chains, and the ops to subtract from each step
_LAT_OPS = (("dadd", ()), ("dfma", ()), ("frnd", ("dadd",)),
            ("dsetp_fsel", ("dadd",)), ("isetp_fsel", ("dadd",)),
            ("shf_lop_lds", ()), ("f2i_i2f", ("dadd",)), ("ddiv", ("dadd",)),
            ("wrap_step", ()))
_LAT_STEPS, _CLOCK_STEPS = 4096, 1 << 19
_OLD_SIGNATURE = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]


def probe_source(src: str, stamps: bool) -> str:
    """src with the span's stamps and record (and the stages' stamps, when
    `stamps`) inserted."""
    src = insert_after(src, "#include <cuda_runtime.h>\n", _PROBE_HEAD)
    for anchor, text in _SPAN_MARKS + (_STAGE_MARKS if stamps else ()):
        src = insert_after(src, anchor, text)
    return src + _PROBE_TAIL


def sources(baseline: pathlib.Path | None, extra=(),
            names=("probe", "span", "latency")) -> dict[str, pathlib.Path]:
    """{library name: its one source}: the checkout's kernel, the copies in
    `names` written under build/phase_sweep/, the baseline if given, and
    the `extra` (name, source) pairs."""
    mine = (build.CSRC / _SOURCE).read_text()
    texts = {"probe": lambda: probe_source(mine, stamps=True),
             "span": lambda: probe_source(mine, stamps=False),
             "latency": lambda: _LATENCY}
    work = build.BUILD_DIR.parent / "phase_sweep"
    out = {"build": build.CSRC / _SOURCE}
    for name in names:
        path = work / name / _SOURCE
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(texts[name]())
        out[name] = path
    if baseline is not None:
        out["baseline"] = baseline
    out.update(extra)
    return out


def build_all(srcs: dict[str, pathlib.Path]):
    """Every library at once: ({name: library}, {name: compiler log},
    {name: library path}); the baseline's entry takes the old arguments."""
    build.library()  # the error strings
    work = build.BUILD_DIR.parent / "phase_sweep"
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        futs = {}
        for name, path in srcs.items():
            tag = re.sub(r"\W", "_", name)
            so = work / f"lib_{tag}_{build.library_path([path]).stem[-16:]}.so"
            futs[name] = (so, pool.submit(build.compile_shared, [path], so)
                          if not so.exists() else None)
        libs, logs, paths = {}, {}, {}
        for name, (so, fut) in futs.items():
            if fut is not None:
                fut.result()
            lib = ctypes.CDLL(str(so))
            if hasattr(lib, "opv_phase_latency"):
                lib.opv_phase_latency.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p]
                lib.opv_phase_latency.restype = ctypes.c_int
            else:
                fn = lib.opv_phase_track
                fn.argtypes = (_OLD_SIGNATURE if name == "baseline"
                               else build.SIGNATURES["opv_phase_track"][0])
                fn.restype = ctypes.c_int
            if hasattr(lib, "opv_phase_probe"):
                lib.opv_phase_probe.argtypes = [ctypes.c_void_p]
                lib.opv_phase_probe.restype = ctypes.c_int
            libs[name], paths[name] = lib, so
            logs[name] = so.with_suffix(".log").read_text()
    return libs, logs, paths


def runner(name: str, lib, ph0: torch.Tensor, incs, n: int):
    """A call of `lib` on ph0's stream returning (phases, final)."""
    if name != "baseline":
        return lambda: pt.launch(lib, ph0, incs, n)[:2]

    def old():
        phases = torch.empty((len(incs), n), dtype=torch.float64,
                             device=ph0.device)
        final = torch.empty((len(incs),), dtype=torch.float64,
                            device=ph0.device)
        err = lib.opv_phase_track(ph0.data_ptr(), float(incs[0]),
                                  float(incs[-1]), len(incs), n,
                                  phases.data_ptr(), final.data_ptr(),
                                  build.stream_ptr(ph0))
        build.check(build.library(), err, "baseline phase_track")
        return phases, final
    return old


def read_probe(lib, tones: int) -> list[dict]:
    """Per tone: cycles a segment by stage (probe) or the span's, the
    segments, the walk's ms (global timer) and the SM clock in MHz (cycles
    over global-timer ns)."""
    buf = (ctypes.c_ulonglong * 12)()
    torch.cuda.synchronize()
    build.check(build.library(), lib.opv_phase_probe(ctypes.addressof(buf)),
                "phase probe")
    out = []
    for t in range(tones):
        acc, span, ns, segs = buf[6 * t:6 * t + 3], *buf[6 * t + 3:6 * t + 6]
        row = {name: acc[q] / segs for q, name in enumerate(STAGES)}
        row.update(span=span / segs, segments=segs, walk_ms=ns / 1e6,
                   sm_mhz=span / ns * 1e3)
        out.append(row)
    return out


def read_latency(lib) -> dict:
    """{op: cycles a dependent step} on one thread, and "sm_mhz": the SM
    clock that clock64() ran at against the global timer."""
    cycles = (ctypes.c_longlong * (len(_LAT_OPS) + 1))()
    ns = ctypes.c_ulonglong()
    err = lib.opv_phase_latency(_LAT_STEPS, _CLOCK_STEPS, cycles,
                                ctypes.byref(ns))
    build.check(build.library(), err, "latency kernel")
    out = {}
    for i, (name, minus) in enumerate(_LAT_OPS):
        out[name] = cycles[i] / _LAT_STEPS - sum(out[m] for m in minus)
    out["sm_mhz"] = cycles[len(_LAT_OPS)] / ns.value * 1e3
    return out


def main_path(dev):
    """bert3's phase_track call: 3 frames x 2 tones from reset."""
    return (torch.zeros(2, dtype=torch.float64, device=dev), (_INC1, _INC2),
            FRAMES * CONFIG.samples_per_frame)


def walk_floor(span: list[dict], lat: dict) -> dict:
    """From the span's rows and the latencies: the walk's measured cycles a
    segment and ms (the longer tone), segments a frame, the SM clock, the
    chain's cycles a segment (FLOOR_CHAIN) and the floor in ms: each
    tone's segments x the chain, at the span's clock, the longer tone."""
    mhz = sum(r["sm_mhz"] for r in span) / len(span)
    chain = floor_cycles(lat, {"segment": FLOOR_CHAIN})["segment"]
    return {"cycles_per_segment": sum(r["span"] for r in span) / len(span),
            "walk_ms": max(r["walk_ms"] for r in span), "sm_mhz": mhz,
            "segments_per_frame": [r["segments"] / FRAMES for r in span],
            "chain_cycles": chain,
            "floor_ms": max(r["segments"] for r in span) * chain / mhz / 1e3}


def segment_floor(dev) -> dict:
    """The span and latency copies alone, built at once and run at the
    main path's shape (the span held bit for bit against the twin first):
    walk_floor's figures."""
    libs, _, _ = build_all(sources(None, names=("span", "latency")))
    ph0, incs, n = main_path(dev)
    got = runner("span", libs["span"], ph0, incs, n)()
    want = pt.phase_track_reference(ph0.cpu(), incs, n)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("phase_track span copy != twin")
    return walk_floor(read_probe(libs["span"], len(incs)),
                      read_latency(libs["latency"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, required=True,
                    help="an older phase_track.cu with the serial kernel's "
                         "C entry (no scratch arguments)")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another phase_track.cu (the checkout's C entry) "
                         "to hold and time")
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/phase_sweep.json"))
    args = ap.parse_args(argv)
    extra = [(e.split("=", 1)[0], pathlib.Path(e.split("=", 1)[1]))
             for e in args.extra]
    if not torch.cuda.is_available():
        raise SystemExit("phase_sweep: no CUDA device")
    card = nvidia_smi("name,power.limit")
    dev = torch.device("cuda", 0)
    libs, logs, paths = build_all(sources(args.baseline, extra))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name in ("build", *(n for n, _ in extra)):
        tag = re.sub(r"\W", "_", name)
        write_sass(paths[name], args.out.with_suffix(f".{tag}.sass"))
    lat = read_latency(libs.pop("latency"))
    report = {"card": card, "reps": REPS,
              "ptxas": {n: ptxas_lines(log) for n, log in logs.items()},
              "latency_cycles": lat}
    for name, lines in report["ptxas"].items():
        print(f"[sweep] {name}: ptxas {lines}", flush=True)
    print("[sweep] cycles a dependent step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in lat.items()) + f" ({card})", flush=True)
    ph0, incs, n = main_path(dev)
    want = pt.phase_track_reference(ph0.cpu(), incs, n)
    for name, lib in libs.items():
        got = runner(name, lib, ph0, incs, n)()
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"phase_track {name} != twin")
        if name in ("probe", "span"):
            report[name] = read_probe(lib, len(incs))
    _, _, segs, counts = pt.launch(libs["build"], ph0, incs, n)
    if pt.segment_tables(segs, counts) != pt.phase_segments_reference(
            ph0.cpu(), incs, n)[2]:
        raise AssertionError("phase_track segment tables != the model's")
    report["floor"] = floor = walk_floor(report["span"], lat)
    report["serial_floor_ms"] = lat["wrap_step"] * n / lat["sm_mhz"] / 1e3
    turns = []
    order = ("build", "baseline", *(n for n, _ in extra))
    for name in (*order, *order[::-1]):
        turns.append([name, cuda_ms(runner(name, libs[name], ph0, incs, n),
                                    REPS)])
    report["turns"] = turns
    print(f"[sweep] every library bit for bit with the twin over {n} samples "
          f"x 2 tones; segment tables equal the model's; segments a frame "
          f"{floor['segments_per_frame']}", flush=True)
    print("[sweep] turns (ms per 3 frames): " + ", ".join(
        f"{nm} {ms:.4f}" for nm, ms in turns) + f" ({card})", flush=True)
    for name in ("probe", "span"):
        for t, row in enumerate(report[name]):
            print(f"[sweep] {name} tone {t}: cycles a segment " + ", ".join(
                f"{k} {v:.1f}" for k, v in row.items()), flush=True)
    print(f"[sweep] walk {floor['walk_ms']:.4f} ms "
          f"({floor['cycles_per_segment']:.1f} cycles a segment); floor "
          f"{floor['floor_ms']:.4f} ms (the chain's {floor['chain_cycles']:.1f} "
          f"cycles a segment x segments, at {floor['sm_mhz']:.0f} MHz "
          f"measured); the serial kernel's floor "
          f"{report['serial_floor_ms']:.4f} ms ({lat['wrap_step']:.1f} "
          f"cycles a sample) ({card})", flush=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[sweep] wrote {args.out} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
