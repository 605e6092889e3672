"""Time the Viterbi kernel (opv_tpu_torch/csrc/viterbi.cu) on one GPU: the
checkout's build, an older source with the same C entry point, and copies
of the checkout's source with one thing changed.

    python scripts/viterbi_sweep.py [--baseline OLD.cu] [--report-only]
                                    [--out build/viterbi_sweep.json]

The copies, written under build/viterbi_sweep/ and built at once with the
checkout's library and the baseline (one nvcc per source):
  warps=N       N frames per block (kWarps) instead of the checkout's
  plain select  the compare-select as a compare and a select, not DPX
                __vibmin_s32
  forward only  no traceback: the add-compare-select loop alone (its bits
                are not decoded, so it is timed, not checked)
First the compiler's register/spill report of each radix and the SASS
instruction counts (cuobjdump) of each radix's steady loop, per trellis
step; --report-only stops there.  Then every library but forward only is
checked against the plain twin on chip_smoke's viterbi_inputs (clean, tie
stress, wide, straddle and random rows) at B = 131 and 1280: bits and metrics
identical, or the run fails; for the baseline the rows where it differs
are listed instead.  Times are chip_smoke's cuda_ms over KERNEL_REPS
launches: at B = 1280 the build and the baseline in turns (build,
baseline, build, baseline), then every copy at B = 1280 and 131.  Without
a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from chip_smoke import (KERNEL_REPS, cuda_ms, int32_ops_per_s, nvidia_smi,  # noqa: E402
                        viterbi_bound, viterbi_inputs)
from opv_tpu_torch.ops import build  # noqa: E402
from opv_tpu_torch.ops import viterbi as vit  # noqa: E402
from soft_sweep import build_all, ptxas_summary, with_source  # noqa: E402

FRAME_BITS = 1072
BATCHES = (1280, 131)
_WARPS = r"constexpr int kWarps = (\d+);"
#: the compare-select written plainly (same semantics: ties keep a)
_DPX = """  bool keep_a;
  const int32_t m = __vibmin_s32(a, b, &keep_a);
  took_b = !keep_a;
  return m;"""
_PLAIN = """  took_b = b < a;
  return took_b ? b : a;"""
#: the traceback call, and what forward only puts in its place (one read of
#: the tape, so its stores stay live)
_TRACE = "traceback<kRadix>(tape, s, bits + (size_t)frame * kFrameBits);"
_NO_TRACE = "bits[(size_t)frame * kFrameBits] = (uint8_t)tape[s];"


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"expected one {old[:40]!r} in the source, found {src.count(old)}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """{name: source} of every copy."""
    warps = int(re.search(_WARPS, src).group(1))
    out = {f"warps={w}": re.sub(_WARPS, f"constexpr int kWarps = {w};", src)
           for w in (1, 2, 4, 8) if w != warps}
    out["plain select"] = replace_once(src, _DPX, _PLAIN)
    out["forward only"] = replace_once(src, _TRACE, _NO_TRACE)
    return out


def radix_label(name: str):
    m = re.search(r"viterbi_kernelILi(\d)E", name)
    return f"radix {m.group(1)}" if m else None


_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_counts(so: pathlib.Path) -> dict:
    """Per radix: instructions of the kernel, and the opcodes of its steady
    loop (the backward branch whose body holds the most SHFL) per trellis
    step.  A trellis step takes 4 SHFL at either radix (8 per double step),
    so steps per pass = SHFL / 4."""
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = radix_label(m.group(1))
            if cur:
                funcs[cur] = ([], {})
            continue
        if cur is None:
            continue
        ins, labels = funcs[cur]
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = _INSTR.search(line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for label, (ins, labels) in funcs.items():
        at = {addr: i for i, (addr, _, _) in enumerate(ins)}
        best = None
        for i, (_, op, rest) in enumerate(ins):
            if not op.startswith("BRA"):
                continue
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", rest)
            j = (labels.get(t.group(1)) if t and t.group(1)
                 else at.get(int(t.group(2), 16)) if t else None)
            if j is None or j > i:
                continue
            body = collections.Counter(o.split(".")[0] for _, o, _ in ins[j:i + 1])
            if best is None or body["SHFL"] > best["SHFL"]:
                best = body
        entry = {"instructions": sum(op != "NOP" for _, op, _ in ins)}
        if best and best["SHFL"]:
            steps = best["SHFL"] / 4
            entry["loop_steps"] = steps
            entry["per_step"] = {op: round(n / steps, 2) for op, n in best.most_common()}
        out[label] = entry
    return out


def runner(lib, soft, radix: int):
    b = soft.shape[0]
    bits = torch.empty((b, FRAME_BITS), dtype=torch.uint8, device=soft.device)
    metrics = torch.empty((b,), dtype=torch.int32, device=soft.device)
    stream = build.stream_ptr(soft)

    def run():
        err = lib.opv_viterbi(soft.data_ptr(), bits.data_ptr(), metrics.data_ptr(),
                              b, radix, stream)
        build.check(lib, err, f"viterbi radix {radix}")
        return bits, metrics
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="an older viterbi.cu exporting opv_viterbi, timed in turns")
    ap.add_argument("--report-only", action="store_true",
                    help="build, print the ptxas and SASS counts, and stop")
    ap.add_argument("--out", type=pathlib.Path,
                    default=pathlib.Path("build/viterbi_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("viterbi_sweep: no CUDA device")
    card = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    work = build.BUILD_DIR.parent / "viterbi_sweep"
    jobs = {}
    for i, (name, src) in enumerate(variants((build.CSRC / "viterbi.cu").read_text()).items()):
        path = work / str(i) / "viterbi.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        jobs[name] = with_source(path, "viterbi.cu")
    if args.baseline:
        jobs["baseline"] = with_source(args.baseline, "viterbi.cu")
    libs, logs = build_all(jobs)
    paths = {"build": pathlib.Path(build.BUILD_INFO["path"]),
             **{name: build.library_path(srcs) for name, srcs in jobs.items()}}
    report = {"card": card, "sm_mhz_max": sm_mhz, "reps": KERNEL_REPS, "libraries": {}}
    for name in libs:
        entry = {"ptxas": ptxas_summary(logs[name], radix_label),
                 "sass": sass_counts(paths[name])}
        report["libraries"][name] = entry
        print(f"[sweep] {name}: ptxas {entry['ptxas']}", flush=True)
        for radix, sass in entry["sass"].items():
            print(f"[sweep] {name} {radix}: {sass['instructions']} instructions; steady "
                  f"loop {sass.get('loop_steps')} trellis steps a pass, per step "
                  f"{sass.get('per_step')}", flush=True)
    if args.report_only:
        return write(report, args.out, card)

    ops_per_s = int32_ops_per_s()
    failed = []
    for radix in (4, 2):
        inputs = {b: viterbi_inputs(b, dev, np.random.default_rng(b))[0] for b in BATCHES}
        want = {b: vit.viterbi_reference(soft, radix) for b, soft in inputs.items()}
        rows = report.setdefault("radix", {})[radix] = {"differs": {}}
        for name, lib in libs.items():
            if name == "forward only":
                continue
            for b, soft in inputs.items():
                bits, metrics = runner(lib, soft, radix)()
                bad = (bits != want[b][0]).any(1) | (metrics != want[b][1])
                if bool(bad.any()):
                    rows["differs"][f"{name} B={b}"] = torch.nonzero(bad)[:, 0].tolist()
                    if name != "baseline":
                        failed.append(f"{name} radix {radix} B={b}")
        for key, bad in rows["differs"].items():
            print(f"[sweep] radix {radix} {key}: differs from the twin on rows {bad}",
                  flush=True)

        def timed(name, b):
            return cuda_ms(runner(libs[name], inputs[b], radix), KERNEL_REPS)
        turns = ["build", "baseline"] * 2 if args.baseline else ["build"] * 2
        rows["turns_1280"] = [[name, timed(name, 1280)] for name in turns]
        for name in libs:
            rows[name] = {b: timed(name, b) for b in BATCHES}
        bound_ms, bound_by = viterbi_bound(1280, ops_per_s)
        rows["bound_1280"] = [bound_ms, bound_by]
        build_ms = min(t for n, t in rows["turns_1280"] if n == "build")
        fwd = rows["forward only"][1280]
        print(f"[sweep] radix {radix} B=1280 turns: " + ", ".join(
            f"{n} {t:.4f}" for n, t in rows["turns_1280"]) + f" ms; bound {bound_ms:.4f} ms "
            f"({bound_by}), build roofline {100 * bound_ms / build_ms:.1f}% ({card})", flush=True)
        print(f"[sweep] radix {radix} B=1280: forward only {fwd:.4f} ms, traceback and "
              f"staging beyond it {build_ms - fwd:.4f} ms; {build_ms * sm_mhz * 1e3 / FRAME_BITS:.1f}"
              f" cycles per trellis step at {sm_mhz:.0f} MHz (forward only "
              f"{fwd * sm_mhz * 1e3 / FRAME_BITS:.1f})", flush=True)
        for name in libs:
            print(f"[sweep] radix {radix} {name}: " + ", ".join(
                f"B={b} {t:.4f} ms" for b, t in rows[name].items()), flush=True)
    report["failed"] = failed
    write(report, args.out, card)
    if failed:
        raise AssertionError(f"kernel != twin: {failed}")
    return 0


def write(report: dict, out: pathlib.Path, card: str) -> int:
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"[sweep] wrote {out} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
