"""AWGN BER / FER sweep of the port (counterpart of tools/ber_curve.py).

BERT frames through an AWGN channel at a range of Eb/N0 points (per-sample
SNR x 40 samples a symbol), demodulated by one receiver path, and the
post-FEC BER and frame error rate of each point:

  locked           rx_locked (the feed-forward locked grid) on complex64
  tracking         rx_batch, the reference-parity tracking loop (float64)
  locked-int8      the locked grid on the int8 stream buffer at the fixed
                   wire-full-scale step INT8_SCALE (the clipping penalty)
  locked-int8-agc  the same at the AGC step min(peak, 3.5 x rms) / 127 the
                   streaming engine adopts (the production int8 behaviour)

The points draw their noise in order from one default_rng(seed), as the
JAX tool does, so a point's capture depends on the points before it.

    python -m opv_tpu_torch.tools.ber_curve [--ebn0 3 5 7 10] [--frames 20]
        [--path locked] [--json FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

PATHS = ("locked", "tracking", "locked-int8", "locked-int8-agc")


def decode(noisy: np.ndarray, frames: np.ndarray, path: str, dev):
    """(frames got (F, 134), metrics (F,)) of one noisy capture: the
    locked paths' frame slots, or the tracking receiver's frames placed at
    the slot their BERT counter names (9999 where none landed)."""
    from opv_tpu_torch.rx.locked import INT8_SCALE, rx_locked
    from opv_tpu_torch.tools.ber_headtohead import int8_buffer, int8_steady
    nf = len(frames)
    if path == "tracking":
        from opv_tpu_torch.rx.pipeline import rx_batch
        res = rx_batch(noisy.astype(np.complex128), device=dev)
        got = np.zeros_like(frames)
        metrics = np.full(nf, 9999, np.int64)
        for fr, me in zip(res["frames"], res["metrics"]):
            slot = int(fr[12])
            if slot < nf:
                got[slot] = fr
                metrics[slot] = me
        return got, metrics
    if path in ("locked-int8", "locked-int8-agc"):
        agc = path == "locked-int8-agc"
        q8, scale, deq = int8_buffer(noisy, None if agc else INT8_SCALE)
        out = int8_steady(q8, deq, nf, dev, scale if agc else None,
                          with_frac=False)
    else:
        x = torch.from_numpy(noisy.astype(np.complex64)).to(dev)[None]
        out = rx_locked(x, n_frames=nf)
    return out["frames"][0].cpu().numpy(), out["metrics"][0].cpu().numpy()


def sweep(ebn0, n_frames: int, seed: int, path: str, dev, progress=None):
    """One row per point: ber, fer, bit/frame errors, frames, mean metric."""
    from opv_tpu_torch.tools.capture import awgn, fast_signal
    frames, s, sig_pow = fast_signal(n_frames, dev)
    frame_bits = np.unpackbits(frames, axis=1)
    rng = np.random.default_rng(seed)
    rows = []
    for ebn0_db in ebn0:
        got, metrics = decode(awgn(s, sig_pow, rng, ebn0_db), frames, path,
                              dev)
        bit_errs = int((np.unpackbits(got, axis=1) != frame_bits).sum())
        frame_errs = int((got != frames).any(axis=1).sum())
        row = {"ebn0_db": ebn0_db, "ber": bit_errs / frame_bits.size,
               "fer": frame_errs / n_frames, "bit_errors": bit_errs,
               "frame_errors": frame_errs, "frames": n_frames,
               "mean_metric": float(metrics.mean())}
        rows.append(row)
        if progress:
            progress(f"Eb/N0 {ebn0_db:5.1f} dB: BER {row['ber']:.2e}  "
                     f"FER {row['fer']:.3f}  mean metric "
                     f"{row['mean_metric']:.0f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ber_curve")
    ap.add_argument("--ebn0", type=float, nargs="+",
                    default=[3.0, 5.0, 7.0, 8.0, 10.0, 12.0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--json", default=None)
    ap.add_argument("--path", choices=PATHS, default="locked")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    dev = resolve_device(args.device)
    rows = sweep(args.ebn0, args.frames, args.seed, args.path, dev,
                 progress=lambda m: print(m, file=sys.stderr, flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    else:
        print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
