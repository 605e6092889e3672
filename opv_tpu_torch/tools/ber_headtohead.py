"""Head-to-head waterfall BER of the port, on the JAX tool's captures
(tools/ber_headtohead.py), held to a committed artifact of that tool.

One seeded AWGN capture per (Eb/N0 point, seed), >= 200 frames each,
made by capture.headtohead_wire, is decoded from the identical int16
wire by:

  * tracking: the reference-parity StreamingDemodulator (float64), with
    its locks, lock drops and sync misses counted from its sync events
    (the reference binary's stderr lines);
  * locked: rx_locked on complex64;
  * locked_int8_agc: rx_locked on the capture dequantized from int8 at the
    AGC step, then rx_locked_steady on the int8 window rows at that step;
  * locked_streaming_bf{4,12}[_int8]: LockedStreamDemodulator(1,
    block_frames=bf) at float32 and int8 rows, fed bf frames at a time.

BER counts bit errors at the best single global alignment; FER counts
frames with any residual error.  The per-seed rows aggregate as the JAX
tool's do (mean rates, summed counters, per-seed BER kept).

The reference binary cannot be built here, so --against names a committed
artifact (BER_r05.json): its `reference` rows are copied into the output
and a `compare` block puts each of the port's figures beside the file's.
The tracking row must equal the reference's; each locked-family row must
be no worse than the JAX package's row by more than 5% (or 2e-5 absolute
at 10 dB and above), decoding within one frame a capture (check()).

    python -m opv_tpu_torch.tools.ber_headtohead --against BER_r05.json \\
        --json BER_TORCH.json [--ebn0 5 6 7 8 10] [--frames 200] \\
        [--seeds 42 43 44 45 46] [--lead 2000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG

#: the row the port's tracking receiver is held to, and the JAX rows its
#: locked family is held to
TRACKING_AGAINST = "reference"
LOCKED_ROWS = ("locked", "locked_int8_agc", "locked_streaming_bf4",
               "locked_streaming_bf4_int8", "locked_streaming_bf12",
               "locked_streaming_bf12_int8")
#: a locked-family BER may exceed the JAX row's by this share ...
LOCKED_REL = 0.05
#: ... or, at and above LOCKED_ABS_DB, by this much
LOCKED_ABS = 2e-5
LOCKED_ABS_DB = 10.0
#: sync-lifecycle counters of the tracking row (rx.sync.EV_* codes)
EVENT_COUNTS = ("locks", "lock_drops", "sync_misses")

MEAN = {"ber", "fer", "ber_steady_tail", "fer_steady_tail"}
SUM = {"decoded", "locks", "lock_drops", "sync_misses", "reacquisitions",
       "timing_refreshes", "wall_s"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def seq_stats(seq, truth):
    """(bit_errors, frame_errors) of a contiguous decoded sequence vs the
    transmitted frames at the best single global alignment; truth rows not
    covered count fully errored."""
    n, fb = truth.shape
    total_bits = truth.size * 8
    if len(seq) == 0:
        return total_bits, n
    seq = np.asarray(seq, np.uint8)
    if len(seq) > n:            # stray extra decodes: score the first n
        seq = seq[:n]
    tb = np.unpackbits(truth, axis=1)
    sb = np.unpackbits(seq, axis=1)
    best = (total_bits, n)
    for d in range(0, n - len(seq) + 1):
        be = int((sb != tb[d:d + len(seq)]).sum()) + (n - len(seq)) * fb * 8
        fe = int((sb != tb[d:d + len(seq)]).any(axis=1).sum()) \
            + (n - len(seq))
        if be < best[0]:
            best = (be, fe)
    return best


def tail_stats(seq, truth, skip: int):
    """BER/FER of a decoded sequence restricted to truth frames >= skip,
    at the full-sequence best alignment: the steady-state view of a causal
    streaming decoder whose first blocks ride a shallow timing fold."""
    n, fb = truth.shape
    if len(seq) == 0:
        return 1.0, 1.0
    seq = np.asarray(seq, np.uint8)[:n]
    tb = np.unpackbits(truth, axis=1)
    sb = np.unpackbits(seq, axis=1)
    best, bd = None, 0
    for d in range(0, n - len(seq) + 1):
        e = int((sb != tb[d:d + len(seq)]).sum())
        if best is None or e < best:
            best, bd = e, d
    errs = (sb != tb[bd:bd + len(sb)])
    # truth-frame index of decoded row i is bd + i
    rows = np.arange(len(sb)) + bd
    m = rows >= skip
    covered = int(m.sum())
    missing = (n - skip) - covered          # uncovered tail truth frames
    be = int(errs[m].sum()) + max(missing, 0) * fb * 8
    fe = int(errs[m].any(axis=1).sum()) + max(missing, 0)
    total = (n - skip) * fb * 8
    return be / total, fe / (n - skip)


def stack_frames(rows) -> np.ndarray:
    """A list of frame bytes -> (n, 134) uint8."""
    if not rows:
        return np.zeros((0, CONFIG.frame_bytes), np.uint8)
    return np.stack([np.frombuffer(r, np.uint8) for r in rows])


def rates(seq, truth) -> dict:
    be, fe = seq_stats(seq, truth)
    return {"ber": be / (truth.size * 8), "fer": fe / len(truth),
            "decoded": len(seq)}


def run_tracking(sw: np.ndarray, truth: np.ndarray, dev) -> dict:
    """The reference-parity receiver on the whole capture, its sync events
    counted as the reference binary's stderr lines are."""
    from opv_tpu_torch.rx.sync import EV_LOSE_LOCK, EV_SYNC_MISS, \
        EV_VERIFY_LOCK
    from opv_tpu_torch.stream import StreamingDemodulator
    codes = []
    t0 = time.time()
    sd = StreamingDemodulator(device=dev,
                              on_event=lambda t, code, *_: codes.append(code))
    res = sd.feed(sw) + sd.flush()
    row = rates(stack_frames([r[0] for r in res]), truth)
    row.update(device=str(dev), locks=codes.count(EV_VERIFY_LOCK),
               lock_drops=codes.count(EV_LOSE_LOCK),
               sync_misses=codes.count(EV_SYNC_MISS)
               + codes.count(EV_LOSE_LOCK),
               wall_s=round(time.time() - t0, 2))
    return row


def _valid_frames(out) -> np.ndarray:
    fv = out["frame_valid"][0].cpu().numpy()
    return out["frames"][0].cpu().numpy()[fv]


def run_locked(sw: np.ndarray, truth: np.ndarray, dev) -> dict:
    from opv_tpu_torch.rx.locked import rx_locked
    t0 = time.time()
    x = torch.from_numpy(sw.astype(np.complex64)).to(dev)[None]
    row = rates(_valid_frames(rx_locked(x, n_frames=len(truth))), truth)
    row["wall_s"] = round(time.time() - t0, 2)
    return row


def int8_buffer(sw: np.ndarray, scale=None):
    """The int8 stream buffer of a capture, as the JAX tools build it: at
    the AGC step min(peak, 3.5 x rms) / 127 (stream/locked.py _agc_update)
    unless `scale` gives the step; (pairs quantized to int8, step, the
    complex64 capture dequantized from them)."""
    pairs = np.stack([sw.real, sw.imag], -1)[: len(sw) // 40 * 40]
    if scale is None:
        scale = min(np.abs(pairs).max(),
                    3.5 * np.sqrt(np.mean(pairs ** 2))) / 127.0
    q8 = np.clip(np.round(pairs / scale), -127, 127).astype(np.int8)
    deq = ((q8[:, 0].astype(np.float32) + 1j * q8[:, 1].astype(np.float32))
           * scale).astype(np.complex64)
    return q8, scale, deq


def int8_steady(q8: np.ndarray, deq: np.ndarray, n_frames: int, dev,
                scale=None, with_frac: bool = True) -> dict:
    """The int8 streaming driver mirrored: acquisition on the capture
    reconstructed from the quantized buffer, then the steady body on the
    int8 window rows at the step `scale` (None: the fixed INT8_SCALE),
    with the acquisition's sub-sample timing where with_frac."""
    from opv_tpu_torch.rx.locked import rx_locked, rx_locked_steady
    acq = rx_locked(torch.from_numpy(deq).to(dev)[None], n_frames=n_frames)
    if scale is not None:
        scale = torch.tensor([scale], dtype=torch.float32, device=dev)
    return rx_locked_steady(torch.from_numpy(q8.reshape(1, -1, 80)).to(dev),
                            acq["p0"], acq["freq_offset"], n_frames=n_frames,
                            scale=scale,
                            frac=acq["frac"] if with_frac else None)


def run_streaming(sx: np.ndarray, truth: np.ndarray, bf: int, dtype: str,
                  dev) -> dict:
    """LockedStreamDemodulator(1, block_frames=bf) fed bf frames at a time,
    then flushed."""
    from opv_tpu_torch.stream import LockedStreamDemodulator
    t0 = time.time()
    sd = LockedStreamDemodulator(1, block_frames=bf, dtype=dtype, device=dev)
    res = []
    step = bf * CONFIG.samples_per_frame
    for off in range(0, sx.shape[1], step):
        res.extend(sd.feed(sx[:, off:off + step]))
    res.extend(sd.flush())
    st = stack_frames([r[1] for r in res])
    nf = len(truth)
    row = rates(st, truth)
    # steady-state view: frames past the causal acquisition transient
    tber, tfer = tail_stats(st, truth, skip=nf // 2)
    row.update(ber_steady_tail=tber, fer_steady_tail=tfer, block_frames=bf,
               dtype=dtype, reacquisitions=sd.reacquisitions,
               timing_refreshes=sd.refreshes,
               wall_s=round(time.time() - t0, 2))
    return row


def capture_rows(sw: np.ndarray, truth: np.ndarray, dev) -> dict:
    """Every receiver's row on one capture (complex128 samples of the
    int16 wire)."""
    nf = len(truth)
    row = {"tracking": run_tracking(sw, truth, dev),
           "locked": run_locked(sw, truth, dev)}
    q8, scale, deq = int8_buffer(sw)
    row["locked_int8_agc"] = rates(
        _valid_frames(int8_steady(q8, deq, nf, dev, scale)), truth)
    sx = sw.astype(np.complex64)[None, :]
    for bf in (4, 12):
        for dtype, key in (("float32", f"locked_streaming_bf{bf}"),
                           ("int8", f"locked_streaming_bf{bf}_int8")):
            row[key] = run_streaming(sx, truth, bf, dtype, dev)
    return row


def aggregate(db: float, nf: int, per_seed: list) -> dict:
    """The independent captures of one point: BER/FER are per-capture rates
    over identical-size captures, so the aggregate is their mean; event
    counters and wall time sum; per-seed BERs are kept."""
    n = len(per_seed)
    row = {"ebn0_db": db, "frames": nf * n, "captures": n}
    for key, ent in per_seed[0].items():
        agg = {}
        for f in ent:
            if f in MEAN:
                agg[f] = sum(pr[key][f] for pr in per_seed) / n
            elif f in SUM:
                agg[f] = round(sum(pr[key][f] for pr in per_seed), 2)
            else:
                agg[f] = ent[f]
        agg["ber_per_seed"] = [round(pr[key]["ber"], 6) for pr in per_seed]
        row[key] = agg
    return row


def compare(rows: list, against: dict) -> list:
    """For each point and row: the port's figure beside the file's (the
    tracking row beside the file's reference row, the others beside the
    file's JAX rows of the same name)."""
    by_db = {r["ebn0_db"]: r for r in against["rows"]}
    out = []
    for row in rows:
        ref = by_db.get(row["ebn0_db"])
        if ref is None:
            continue
        ent = {"ebn0_db": row["ebn0_db"]}
        for key in ("tracking",) + LOCKED_ROWS:
            theirs = ref[TRACKING_AGAINST if key == "tracking" else key]
            fields = ["ber", "fer", "decoded", "ber_per_seed"]
            if key == "tracking":
                fields += list(EVENT_COUNTS)
            ent[key] = {"against": TRACKING_AGAINST if key == "tracking"
                        else key, **{f: [row[key][f], theirs[f]]
                                     for f in fields}}
        out.append(ent)
    return out


def check(out: dict) -> list:
    """The holds that fail, one line each (empty when the port holds):
    the tracking row equal to the reference's (per-seed BER to 6 decimals,
    decoded, FER, locks, lock drops, sync misses); each locked-family row
    no worse than the JAX row by more than LOCKED_REL (or LOCKED_ABS at
    and above LOCKED_ABS_DB), its decoded within one frame a capture."""
    bad = []
    for ent in out["compare"]:
        db = ent["ebn0_db"]
        trk = ent["tracking"]
        for f in ("ber_per_seed", "decoded", "fer") + EVENT_COUNTS:
            ours, theirs = trk[f]
            if ours != theirs:
                bad.append(f"{db} dB tracking {f}: {ours} against the "
                           f"reference's {theirs}")
        for key in LOCKED_ROWS:
            (ours, theirs), (d_ours, d_theirs) = (ent[key]["ber"],
                                                  ent[key]["decoded"])
            ok = ours <= theirs * (1 + LOCKED_REL) or (
                db >= LOCKED_ABS_DB and ours <= theirs + LOCKED_ABS)
            if not ok:
                bad.append(f"{db} dB {key} BER {ours:.6g} against JAX's "
                           f"{theirs:.6g}")
            if abs(d_ours - d_theirs) > len(ent[key]["ber_per_seed"][0]):
                bad.append(f"{db} dB {key} decoded {d_ours} against JAX's "
                           f"{d_theirs}")
    return bad


def headtohead(ebn0, frames: int, seeds, lead: int, dev,
               against: dict | None = None, progress=log) -> dict:
    """The tool's JSON object: one aggregated row per point, the file's
    reference rows copied in and the compare block where `against` is
    given."""
    from opv_tpu_torch.tools.capture import (exact_signal, headtohead_wire,
                                             wire_to_complex)
    truth, s, sig_pow = exact_signal(frames, dev)
    ref_rows = {r["ebn0_db"]: r for r in against["rows"]} if against else {}
    rows = []
    for db in ebn0:
        per_seed = []
        for seed in seeds:
            sw = wire_to_complex(headtohead_wire(s, sig_pow, seed, db, lead))
            per_seed.append(capture_rows(sw, truth, dev))
        row = aggregate(db, frames, per_seed)
        if db in ref_rows:
            row["reference"] = ref_rows[db][TRACKING_AGAINST]
        rows.append(row)
        progress(f"Eb/N0 {db:4.1f} dB ({len(seeds)} captures): "
                 + " | ".join(f"{k} {row[k]['ber']:.3e}"
                              for k in ("tracking",) + LOCKED_ROWS))
    out = {"frames_per_capture": frames, "seeds": list(seeds),
           "lead_noise_samples": lead,
           "alignment": "best single global shift; uncovered truth rows "
                        "count fully errored",
           "device": str(dev), "rows": rows}
    if against is not None:
        out["compare"] = compare(rows, against)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ber_headtohead")
    ap.add_argument("--ebn0", type=float, nargs="+",
                    default=[5.0, 6.0, 7.0, 8.0, 10.0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46],
                    help="one independent capture per seed per point; a "
                         "single 200-frame capture's BER at the waterfall "
                         "swings ~20%% between noise realizations")
    ap.add_argument("--lead", type=int, default=2000,
                    help="noise-only samples before the signal (real "
                         "captures begin with noise)")
    ap.add_argument("--against", default=None,
                    help="a committed head-to-head artifact (BER_r05.json) "
                         "whose reference rows stand in for the binary")
    ap.add_argument("--json", default=None)
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    from opv_tpu_torch.tools.capture import card_name
    from opv_tpu_torch.tools.timing import commit
    dev = resolve_device(args.device)
    against = json.loads(pathlib.Path(args.against).read_text()) \
        if args.against else None
    t0 = time.time()
    out = headtohead(args.ebn0, args.frames, args.seeds, args.lead, dev,
                     against)
    out.update(card=card_name() if dev.type == "cuda" else None,
               commit=args.commit or commit(), against=args.against,
               wall_s=round(time.time() - t0, 1))
    bad = check(out) if against is not None else []
    out["holds"] = not bad
    for line in bad:
        log(f"does not hold: {line}")
    txt = json.dumps(out)
    if args.json:
        pathlib.Path(args.json).write_text(txt + "\n")
    print(txt)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
