"""Per-stage timing of the locked-grid receiver on the card (counterpart of
tools/stage_bench.py): each stage of the steady body timed alone, by CUDA
events, on device-resident inputs.

  soft         rx/locked.py::_symbol_soft_batch (the operands built in
               torch, then K3), per row type: float32, int8 (the wire over
               INT8_SCALE) and float64 (complex128 input)
  soft_kernel  K3 alone (registry.symbol_soft on those operands), with
               torch.bmm of the same correlation beside it on float32 and
               float64 rows (full float32: TF32 must be off)
  extract      _extract_frames: frame slices and sync quality
  viterbi      registry.viterbi_batch on the (C*F, 2144) deinterleaved
               soft values, per --radix (K1: 4, K2: 2)
  finish       decode_payloads: quantize, deinterleave, Viterbi, pack,
               derandomize, per --radix
  steady       rx_locked_steady, 20 blocks back to back, per row type:
               ms per block and Msamples/s

The signal is bench.py's (C channels of one fast-TX stream of F frames,
delays (c % 40) + 487 c), made on the card.  Each figure is the median of
5 windows with its min and max; stages whose launches cost the host more
than the card are timed with the launches queued behind a sleep kernel
(timing.event_windows), so they read device time; steady is not (it reads
what the host-driven body gives).  The Viterbi's input is left in L2 as
its caller leaves it; the soft stage reads rows far beyond L2's 50 MB.
Each stage has a roofline against the H100's published peaks.

Decode checks (a failed one exits 1): acquisition decodes C*F frames;
every steady block decodes C*F frames; the int8 and float64 rows decode
the frames the float32 rows decode.

    python -m opv_tpu_torch.tools.stage_bench [--channels 64] [--frames 20]
        [--rows float32 int8 float64] [--radix 4 2] [--reps 20]
        [--json FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROWS = {"float32": torch.float32, "int8": torch.int8, "float64": torch.float64}
#: the peak rate of each row type's correlation
ROW_PEAK = {"float32": "f32", "int8": "int8", "float64": "f64"}
#: calls per CUDA-event window of the short stages
STAGE_CALLS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def window_rows(x: torch.Tensor, rows: str) -> torch.Tensor:
    """The steady body's buffer of `x` for a row type."""
    from opv_tpu_torch.rx.locked import to_window_rows
    if rows == "float64":
        return to_window_rows(x.to(torch.complex128), torch.float64)
    return to_window_rows(x, ROWS[rows])


def bench(c: int, f: int, row_types, radices, reps: int, dev) -> dict:
    """The record's stages, rooflines and checks."""
    from opv_tpu_torch.core.framing import device_table
    from opv_tpu_torch.core.interleave import deinterleave_gather
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.ops.symbol_soft import moved_bytes
    from opv_tpu_torch.rx.frame_decoder import decode_payloads, quantize_soft
    from opv_tpu_torch.rx.locked import (_extract_frames, _symbol_soft_batch,
                                         rx_locked, rx_locked_steady,
                                         soft_stage_operands)
    from opv_tpu_torch.tools import timing
    from opv_tpu_torch.tools.capture import smoke_signal
    on_card = timing.measures(dev)
    if on_card and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; torch.bmm beside K3 must "
                           "run in full float32")
    int_rate = timing.int32_ops_per_s() if on_card else None
    x, frames, _ = smoke_signal(c, f, dev)
    n = x.shape[1]
    log(f"signal: {c} x {n} samples on {dev}")
    acq = rx_locked(x, n_frames=f, estimate_cfo_flag=True)
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]
    failures = []
    if int(acq["n_decoded"]) != c * f:
        failures.append(f"acquisition decoded {int(acq['n_decoded'])} of "
                        f"{c * f}")
    r = p0 % 40
    k0 = (p0 - r) // 40
    radix0 = registry.get_viterbi_radix()
    registry.set_viterbi_radix(radices[0])
    stages, decoded = {}, {}
    soft0 = None
    for rows_name in row_types:
        rows = window_rows(x, rows_name)
        nsym = rows.shape[1] - 1
        peak = timing.PEAK_OPS_PER_S[ROW_PEAK[rows_name]]
        ops = soft_stage_operands(rows, r, foff, nsym, None, frac)
        nbytes = moved_bytes(*ops, nsym)
        work = [(2 * ops[0][:, : nsym + 1].numel() * 8, peak)]
        t = timing.timed(lambda: _symbol_soft_batch(rows, r, foff, nsym,
                                                    None, frac),
                         dev, STAGE_CALLS, queue=True)
        stages[f"soft[{rows_name}]"] = dict(
            timing=t, roofline=timing.roofline(nbytes, work, t))
        t = timing.timed(lambda: registry.symbol_soft(*ops, nsym), dev,
                         STAGE_CALLS, queue=True)
        entry = dict(timing=t, roofline=timing.roofline(nbytes, work, t))
        if rows_name != "int8":
            a, b = ops[0][:, : nsym + 1], ops[1]
            entry["library"] = dict(call="torch.bmm", timing=timing.timed(
                lambda: torch.bmm(a, b), dev, STAGE_CALLS, queue=True))
        else:
            entry["library"] = dict(call=None, why="torch.bmm takes no int8 "
                                    "on CUDA")
        stages[f"soft_kernel[{rows_name}]"] = entry
        if soft0 is None:
            soft0 = _symbol_soft_batch(rows, r, foff, nsym, None, frac)
        # every steady block's count, kept on the device until the end
        counts = []

        def steady():
            out = rx_locked_steady(rows, p0, foff, f, frac=frac)
            counts.append(out["n_decoded"])
            return out
        out = steady()
        t = timing.timed(steady, dev, reps)
        blocks = torch.stack(counts).cpu()
        if not bool((blocks == c * f).all()):
            failures.append(f"steady {rows_name}: blocks decoded "
                            f"{sorted(set(blocks.tolist()))} of {c * f}")
        decoded[rows_name] = out
        _, vops = timing.viterbi_work(c * f)
        sbytes = rows.numel() * rows.element_size() + c * f * (134 + 4 + 1
                                                                + 2 * 4)
        stages[f"steady[{rows_name}]"] = dict(
            timing=t, blocks_checked=len(blocks),
            msamples_s=timing.rate(c * n, t),
            roofline=timing.roofline(sbytes, work + [(vops, int_rate)],
                                     t))
        log(f"{rows_name}: soft {stages[f'soft[{rows_name}]']['timing']}; "
            f"steady {t}")
        del rows, ops
    want = decoded[row_types[0]]
    for rows_name, out in decoded.items():
        if not (torch.equal(out["frames"], want["frames"])
                and torch.equal(out["frame_valid"], want["frame_valid"])):
            failures.append(f"{rows_name} rows decode other frames than "
                            f"{row_types[0]} rows")
    if not torch.equal(want["frames"].cpu(),
                       torch.from_numpy(frames)[None].expand(c, -1, -1)):
        failures.append("the steady frames are not the transmitted frames")
    # extract, viterbi and finish on the first row type's soft stream
    esize = soft0.element_size()
    t = timing.timed(lambda: _extract_frames(soft0, k0, f), dev,
                     STAGE_CALLS, queue=True)
    stages["extract"] = dict(timing=t, roofline=timing.roofline(
        soft0.numel() * esize + c * f * (2144 + 2) * esize,
        [(c * f * 24 * 4, timing.PEAK_OPS_PER_S["f64"])], t))
    payloads = _extract_frames(soft0, k0, f)[0].reshape(-1, 2144)
    q, _ = quantize_soft(payloads)
    gather = device_table(deinterleave_gather, q.device, torch.int64)
    deint = q[..., gather].contiguous()
    b = deint.shape[0]
    vbytes, vops = timing.viterbi_work(b)
    for radix in radices:
        registry.set_viterbi_radix(radix)
        t = timing.timed(lambda: registry.viterbi_batch(deint), dev,
                         2 * STAGE_CALLS, queue=True)
        stages[f"viterbi[r{radix}]"] = dict(
            timing=t, frames=b,
            roofline=timing.roofline(vbytes, [(vops, int_rate)], t))
        t = timing.timed(lambda: decode_payloads(payloads), dev,
                         STAGE_CALLS, queue=True)
        stages[f"finish[r{radix}]"] = dict(timing=t, roofline=timing.roofline(
            payloads.numel() * esize + b * (134 + 4 + 1),
            [(vops, int_rate)], t))
        got, metrics, _ = decode_payloads(payloads)
        if not (bool((metrics == 0).all())
                and torch.equal(got.reshape(c, f, 134), want["frames"])):
            failures.append(f"finish radix {radix}: frames or metrics "
                            "differ from the steady body's")
        log(f"radix {radix}: viterbi {stages[f'viterbi[r{radix}]']['timing']}")
    registry.set_viterbi_radix(radix0)
    return dict(channels=c, frames_per_chan=f, samples_per_block=c * n,
                decoded_per_block=c * f, stages=stages,
                checks=dict(passed=not failures, failures=failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stage_bench")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--rows", nargs="+", choices=tuple(ROWS),
                    default=list(ROWS))
    ap.add_argument("--radix", type=int, nargs="+", choices=(4, 2),
                    default=[4, 2])
    ap.add_argument("--reps", type=int, default=20,
                    help="steady blocks back to back in a window")
    ap.add_argument("--json", default=None)
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    from opv_tpu_torch.tools.timing import header
    dev = resolve_device(args.device)
    out = header("stage_bench", argv if argv is not None else sys.argv[1:],
                 dev, args.commit)
    out.update(bench(args.channels, args.frames, args.rows, args.radix,
                     args.reps, dev))
    txt = json.dumps(out)
    if args.json:
        pathlib.Path(args.json).write_text(txt + "\n")
    print(txt)
    for line in out["checks"]["failures"]:
        log(f"check failed: {line}")
    return 0 if out["checks"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
