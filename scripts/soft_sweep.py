"""Time the soft-stage kernel (opv_tpu_torch/csrc/symbol_soft.cu) on one
GPU: the checkout's build, copies of its source with other tile/stage
settings, an older source with the same C entry point, and torch.bmm of
the correlation alone.

    python scripts/soft_sweep.py [--baseline OLD.cu] [--out build/soft_sweep.json]

Shapes are the main path's: 64 channels x 44,228 window rows, float32 and
int8, seeded random data (the kernel's work does not depend on it).  Each
variant is a copy of the checkout's source, written under
build/soft_sweep/, with the Config<threads, rows per thread, stages> of
its row-type traits changed; every variant is built at once (one nvcc per
source), checked against the plain twin (float32 within chip_smoke's
SOFT_RTOL of max|soft|, the int8 dot exact) and timed with CUDA events over
chip_smoke's KERNEL_REPS launches.  The checkout's build, the baseline and
torch.bmm run in turns (build, baseline, bmm, build) before and after the
variants, so drift shows.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import KERNEL_REPS, SOFT_RTOL, cuda_ms, nvidia_smi  # noqa: E402
from opv_tpu_torch.ops import build  # noqa: E402
from opv_tpu_torch.ops import symbol_soft as ss  # noqa: E402
from opv_tpu_torch.rx.locked import soft_stage_operands  # noqa: E402
from opv_tpu_torch.tools.timing import HBM_BYTES_PER_S  # noqa: E402

CHANNELS, ROWS = 64, 44_228
#: variants: (threads, rows per thread, stages) for float32 rows, then int8
VARIANTS = [((128, 1, 2), (128, 1, 3)),
            ((128, 1, 4), (256, 1, 2)),
            ((64, 1, 3), (256, 1, 4)),
            ((64, 1, 4), (512, 1, 2)),
            ((256, 1, 2), (512, 1, 3)),
            ((128, 1, 3), (256, 1, 3)),
            ((64, 2, 2), (128, 1, 2)),
            ((64, 1, 2), (64, 1, 4))]
_CONFIG = r"(struct {} : Config<)\d+, \d+, \d+(>)"


def variant_source(src: str, f32, i8) -> str:
    """The kernel source with each row type's Config<> replaced."""
    for traits, cfg in (("F32Rows", f32), ("I8Rows", i8)):
        src, n = re.subn(_CONFIG.format(traits),
                         rf"\g<1>{cfg[0]}, {cfg[1]}, {cfg[2]}\g<2>", src)
        if n != 1:
            raise ValueError(f"{traits}: expected one Config<> line, found {n}")
    return src


def with_source(path: pathlib.Path, name: str) -> list[pathlib.Path]:
    """The checkout's kernel sources with csrc/`name` swapped for `path`
    (an older or changed copy of that source)."""
    return [p for p in sorted(build.CSRC.glob("*.cu")) if p.name != name] + [path]


def load_baseline(so: pathlib.Path) -> ctypes.CDLL:
    """An older library exports opv_symbol_soft but no config call."""
    lib = ctypes.CDLL(str(so))
    for name in ("opv_symbol_soft", "opv_error_string"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build.SIGNATURES[name]
    return lib


def operands(dtype, dev):
    """The soft stage's operands at the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (CHANNELS, ROWS, 80)
    if dtype == torch.int8:
        rows = torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    else:
        rows = 3000.0 * torch.randn(shape, generator=g, device=dev)
    rng = np.random.default_rng(5)
    r = torch.from_numpy(rng.integers(0, 40, CHANNELS)).to(dev)
    foff = torch.from_numpy(rng.uniform(-300, 300, CHANNELS).astype(np.float32)).to(dev)
    frac = torch.from_numpy(rng.uniform(0, 1, CHANNELS).astype(np.float32)).to(dev)
    scale = torch.from_numpy(rng.uniform(100, 160, CHANNELS).astype(np.float32)).to(dev)
    return soft_stage_operands(rows, r, foff, ROWS - 1,
                               scale if dtype == torch.int8 else None, frac)


def runner(lib, ops, nsym: int, raw: bool = False):
    rows = ops[0]
    shape = (rows.shape[0], nsym + 1, 8) if raw else (rows.shape[0], nsym)
    dt = (torch.int32 if rows.dtype == torch.int8 else torch.float32) if raw \
        else torch.float32
    out = torch.empty(shape, dtype=dt, device=rows.device)

    def run():
        ss.launch(lib, *ops, out, nsym, raw)
        return out
    return run


def check(lib, ops, nsym: int, want, want_raw) -> float:
    """Relative soft error against the twin; raises on a wrong dot."""
    got = runner(lib, ops, nsym)().clone()
    raw = runner(lib, ops, nsym, raw=True)().clone()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) / float(want.abs().max())
    if ops[0].dtype == torch.int8:
        ok = torch.equal(raw, want_raw)
    else:
        ok = float((raw - want_raw).abs().max()) <= SOFT_RTOL * float(want_raw.abs().max())
    if not (ok and err <= SOFT_RTOL):
        raise AssertionError(f"kernel != twin (soft rel err {err:.3g}, raw ok {ok})")
    return err


def ptxas_summary(log: str, label_of) -> dict:
    """The register/spill lines of each kernel instantiation that
    label_of(mangled name) names (None: not reported)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = label_of(m.group(1))
        elif cur and ("registers" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


def soft_label(name: str):
    if "symbol_soft" in name:
        return "int8" if "I8Rows" in name else "f32"
    return None


def build_all(jobs: dict, load=None):
    """Build the checkout's library and every job {name: sources} at once
    (one nvcc per source): ({name: library}, {name: compiler log}), the
    checkout's under "build".  load(name, so) loads a job's library
    (default build.load)."""
    libs, logs = {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        main = pool.submit(build.library)
        futs = {}
        for name, srcs in jobs.items():
            so = build.library_path(srcs)
            futs[name] = (so, pool.submit(build.compile_shared, srcs, so))
        libs["build"] = main.result()
        logs["build"] = build.BUILD_INFO["ptxas"]
        for name, (so, fut) in futs.items():
            fut.result()
            libs[name] = load(name, so) if load else build.load(so)
            logs[name] = so.with_suffix(".log").read_text()
    return libs, logs


def soft_jobs(baseline: pathlib.Path | None) -> dict:
    """Every Config<> variant, written under build/soft_sweep/, and the
    baseline: {name: sources}."""
    src = (build.CSRC / "symbol_soft.cu").read_text()
    work = build.BUILD_DIR.parent / "soft_sweep"
    jobs = {}
    for f32, i8 in VARIANTS:
        path = work / f"{len(jobs)}" / "symbol_soft.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(variant_source(src, f32, i8))
        jobs[f"f32 {f32} / int8 {i8}"] = with_source(path, "symbol_soft.cu")
    if baseline:
        jobs["baseline"] = with_source(baseline, "symbol_soft.cu")
    return jobs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="an older symbol_soft.cu exporting opv_symbol_soft, "
                         "timed in turns")
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/soft_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("soft_sweep: no CUDA device")
    card = nvidia_smi("name,power.limit")
    dev = torch.device("cuda", 0)
    libs, logs = build_all(soft_jobs(args.baseline),
                           lambda name, so: (load_baseline(so) if name == "baseline"
                                             else build.load(so)))
    logs = {name: ptxas_summary(log, soft_label) for name, log in logs.items()}
    print(f"[sweep] {card}; built {len(libs)} libraries", flush=True)

    report = {"card": card, "reps": KERNEL_REPS, "rows": {}}
    for label, dtype in (("f32", torch.float32), ("int8", torch.int8)):
        ops = operands(dtype, dev)
        nsym = ROWS - 1
        want = ss.symbol_soft_reference(*ops, nsym)
        want_raw = ss.symbol_soft_reference(*ops, nsym, raw=True)
        nbytes = ss.moved_bytes(*ops, nsym)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        turns = ["build", "baseline"] if args.baseline else ["build"]
        if dtype == torch.float32:
            turns.append("bmm")
        turns.append("build")
        entry = {"bound_ms": bound, "bytes": nbytes,
                 "turns": [], "variants": []}

        def timed(name):
            if name == "bmm":
                rows, kern = ops[0][:, : nsym + 1], ops[1]
                return cuda_ms(lambda: torch.bmm(rows, kern), KERNEL_REPS)
            return cuda_ms(runner(libs[name], ops, nsym), KERNEL_REPS)

        for name in turns:
            if name != "bmm":
                check(libs[name], ops, nsym, want, want_raw)
            entry["turns"].append([name, timed(name)])
        for name in libs:
            if name in ("build", "baseline"):
                continue
            is8 = dtype == torch.int8
            row = {"variant": name, "ptxas": logs[name].get(label, [])}
            try:
                row["config"] = ss.kernel_config(is8, libs[name])
                row["rel_err"] = check(libs[name], ops, nsym, want, want_raw)
                row["ms"] = timed(name)
                row["roofline"] = bound / row["ms"]
            except (RuntimeError, AssertionError) as e:
                row["error"] = str(e)
            entry["variants"].append(row)
        for name in turns:
            entry["turns"].append([name, timed(name)])
        # half the rows: t(full) - t(half) is the per-byte part, and
        # 2 t(half) - t(full) the fixed part (launch, ramp-up, tail)
        entry["half_ms"] = cuda_ms(runner(libs["build"], ops, nsym // 2),
                                   KERNEL_REPS)
        entry["config"] = ss.kernel_config(dtype == torch.int8, libs["build"])
        entry["ptxas"] = logs["build"].get(label, [])
        report["rows"][label] = entry
        print(f"[sweep] {label}: bound {bound:.4f} ms; build {entry['config']}; "
              f"ptxas {entry['ptxas']}", flush=True)
        print(f"[sweep] {label} turns: " + ", ".join(
            f"{n} {t:.4f}" for n, t in entry["turns"]) + " ms", flush=True)
        full = entry["turns"][-1][1]
        print(f"[sweep] {label} build at nsym {nsym // 2}: {entry['half_ms']:.4f}"
              f" ms; fixed part 2 t(half) - t(full) = "
              f"{2 * entry['half_ms'] - full:.4f} ms", flush=True)
        for row in entry["variants"]:
            cfg = row.get("config", {})
            print(f"[sweep] {label} {row['variant']}: "
                  + (f"{row['ms']:.4f} ms ({100 * row['roofline']:.1f}% of bound), "
                     f"smem {cfg['smem_bytes']} B, grid {cfg['grid']}, {row['ptxas']}"
                     if "ms" in row else f"ERROR {row['error']}"), flush=True)
        del ops, want, want_raw
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[sweep] wrote {args.out} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
