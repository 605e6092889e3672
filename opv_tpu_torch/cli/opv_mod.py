"""opv-mod — OPV MSK modulator CLI, flag-compatible with the reference
binary (src/opv-mod.cpp:393-533).

Modes:
  -B N   BERT mode: generate N test frames (requires -S CALLSIGN)
  -R     raw mode: read 134-byte frames from stdin
Options:
  -t TOKEN  24-bit token (default 0xBBAADD)
  -c        continuous BERT looping
  -v        verbose
  --fast    closed-form waveform synthesis (IQ may differ from the
            reference by at most 1 LSB).  Default is the reference-exact
            float64 path (its phase recurrence is a CUDA kernel on the
            card).
  --device  cuda (default), cuda:N or cpu

Output: interleaved little-endian int16 IQ on stdout, 100 zero-symbols flush
at EOF (opv-mod.cpp:528-530).  Exit codes and stderr messages match the
reference where practical.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opv-mod", add_help=False)
    ap.add_argument("-S", dest="callsign", default="")
    ap.add_argument("-B", dest="bert_frames", type=int, default=0)
    ap.add_argument("-t", dest="token", default="0xBBAADD")
    ap.add_argument("-R", dest="raw_mode", action="store_true")
    ap.add_argument("-c", dest="continuous", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-h", action="store_true", dest="help")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.help:
        print(__doc__, file=sys.stderr)
        return 1
    if args.raw_mode and args.bert_frames > 0:
        print("Error: -R and -B are mutually exclusive", file=sys.stderr)
        return 1
    if not args.raw_mode and args.bert_frames <= 0:
        print("Error: Must specify either -R (raw mode) or -B N (BERT mode)",
              file=sys.stderr)
        return 1
    if not args.raw_mode and not args.callsign:
        print("Error: BERT mode requires -S CALLSIGN", file=sys.stderr)
        return 1
    callsign = args.callsign
    if len(callsign) > 9:
        print("Warning: Callsign truncated to 9 characters for Base-40 encoding",
              file=sys.stderr)
        callsign = callsign[:9]
    token = int(args.token, 0)

    from opv_tpu_torch.cli._device import DeviceError, resolve_device
    try:
        dev = resolve_device(args.device)
    except DeviceError as e:
        print(f"opv-mod: {e}", file=sys.stderr)
        return 1

    import numpy as np
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
    from opv_tpu_torch.tx.modulator import (mod_reset, modulate_frames,
                                            tx_flush_zeros)

    out = sys.stdout.buffer
    exact = not args.fast
    state = mod_reset()

    def emit(frames_u8: np.ndarray, state):
        enc = encode_frame(torch.tensor(frames_u8, device=dev))
        iq, state = modulate_frames(enc, state=state, exact=exact)
        out.write(iq.cpu().numpy().astype("<i2").tobytes())
        return state

    frame_count = 0
    if args.raw_mode:
        fb = CONFIG.frame_bytes
        stdin = sys.stdin.buffer
        while True:
            buf = stdin.read(fb)
            if not buf:
                break
            if len(buf) < fb:
                print(f"Warning: EOF after partial frame ({len(buf)} bytes)",
                      file=sys.stderr)
                break
            frame = np.frombuffer(buf, dtype=np.uint8).reshape(1, fb)
            state = emit(frame, state)
            frame_count += 1
            if args.verbose and frame_count % 100 == 0:
                print(f"Sent {frame_count} frames", file=sys.stderr)
        if args.verbose:
            print(f"End of input. Total frames: {frame_count}", file=sys.stderr)
    else:
        # bounded batches: memory stays flat and IQ streams out promptly (a
        # live SDR reading stdout must not wait for the whole -B N batch)
        batch = 25
        while True:
            sent = 0
            while sent < args.bert_frames:
                k = min(batch, args.bert_frames - sent)
                frames = build_bert_frame(callsign, token,
                                          frame_count + np.arange(k))
                state = emit(frames, state)
                frame_count += k
                sent += k
                if args.verbose:
                    print(f"Sent frame {sent}/{args.bert_frames}",
                          file=sys.stderr)
            if not args.continuous:
                break
            state = mod_reset()   # the reference resets at each BERT loop

    out.write(tx_flush_zeros().numpy().astype("<i2").tobytes())
    out.flush()
    if args.verbose:
        print("Done.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
