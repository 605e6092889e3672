"""opv-modem — UDP modem server for Interlocutor integration, flag-compatible
with the reference binary (src/opv-modem.cpp:542-1006) and with opv_tpu's
opv-modem on the paths ported so far.

Modes:
  -l          loopback: UDP frame -> modulate -> demodulate -> return to sender
  -t          TX: UDP frame -> modulate -> IQ on stdout (for PlutoSDR)
  -R          RX: IQ on stdin -> demodulate -> frames to UDP 127.0.0.1:resp
  (default)   monitor only
Options:
  -p PORT     UDP listen port (default 57372)
  -r PORT     response port (RX default 57373; loopback: override reply port)
  -c CALL     rewrite callsign on returned frames (loopback repeater), with
              self-frame skip to prevent feedback loops
  -d PATH     accepted for compat (the demodulator is an in-process library
              call here, not a subprocess)
  -o FILE     tee modulated IQ to file
  -v / -q     verbose / quiet
  --fast      fast TX synthesis, and the locked-grid engine demodulates in
              -l/-R (1 channel, block_frames 1, eager serving); without it
              -l/-R demodulate with the reference-parity float64 tracking
              demodulator (StreamingDemodulator), as the reference does
  --device    cuda (default), cuda:N or cpu

TX is reference-exact by default (its float64 phase recurrence is a CUDA
kernel on the card).  The reference's fork/exec demod subprocess and pipe
plumbing (opv-modem.cpp:349-477) is an in-process engine here, and the
event loop polls a UDPFrameBridge (opv-modem.cpp:875-889).
"""

from __future__ import annotations

import argparse
import signal
import socket
import sys

import numpy as np

_RULE = "═══════════════════════════════════════════════════════════════════"


class _Demod:
    """The demodulator of -l/-R, returning decoded frames' bytes.

    --fast: the locked engine, 1 channel, block_frames 1 and eager, so a
    steady frame is emitted as soon as its sync, payload and one symbol of
    slack are buffered (about one frame time, the reference modem's own
    chunk gate, opv-modem.cpp:875-961); not pipelined: the serving loop is
    latency-bound and shares the process with the modulator.  Otherwise
    the tracking StreamingDemodulator, which emits a frame once the
    86,720-sample chunk holding its end is full."""

    def __init__(self, fast: bool, device):
        from opv_tpu_torch.stream import (LockedStreamDemodulator,
                                          StreamingDemodulator)
        self._fast = fast
        self._sd = (LockedStreamDemodulator(channels=1, block_frames=1,
                                            eager=True, device=device)
                    if fast else StreamingDemodulator(device=device))

    def _frames(self, results) -> list:
        return [r[1] if self._fast else r[0] for r in results]

    def feed(self, x) -> list:
        """x: (n,) complex samples or (n, 2) int16 wire pairs."""
        if self._fast:
            return self._frames(self._sd.feed(x[None]))
        if x.ndim == 2:
            x = x[:, 0].astype(np.float64) + 1j * x[:, 1]
        return self._frames(self._sd.feed(x))

    def flush(self) -> list:
        return self._frames(self._sd.flush())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opv-modem", add_help=False)
    ap.add_argument("-p", dest="port", type=int, default=57372)
    ap.add_argument("-r", dest="response_port", type=int, default=0)
    ap.add_argument("-l", dest="loopback", action="store_true")
    ap.add_argument("-t", dest="tx_mode", action="store_true")
    ap.add_argument("-R", dest="rx_mode", action="store_true")
    ap.add_argument("-c", dest="rewrite_callsign", default="")
    ap.add_argument("-d", dest="demod_path", default="")
    ap.add_argument("-o", dest="iq_file", default="")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-h", dest="help", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args(argv)

    err = sys.stderr
    if args.help:
        print(__doc__, file=err)
        return 1
    if (args.loopback + args.tx_mode + args.rx_mode) > 1:
        print("Error: Cannot combine -l, -t, and -R modes", file=err)
        return 1
    if args.rx_mode and args.response_port == 0:
        args.response_port = 57373

    from opv_tpu_torch.cli._device import DeviceError, resolve_device
    try:
        dev = resolve_device(args.device)
    except DeviceError as e:
        print(f"opv-modem: {e}", file=err)
        return 1

    from opv_tpu_torch.core.base40 import _CHARSET_REV, base40_encode
    from opv_tpu_torch.utils.display import banner

    rewrite_bytes = b""
    if args.rewrite_callsign:
        if not all(c in _CHARSET_REV for c in args.rewrite_callsign):
            print(f"Error: Invalid callsign '{args.rewrite_callsign}'", file=err)
            print("Use A-Z, 0-9, -, /, . only", file=err)
            return 1
        rewrite_bytes = base40_encode(args.rewrite_callsign)

    if not args.quiet:
        banner("OPV Modem Server v1.3 (opv_tpu_torch)", out=err)
        if args.rx_mode:
            print("  Mode:      RX (stdin → demod → UDP)", file=err)
            print(f"  Send to:   127.0.0.1:{args.response_port}", file=err)
        else:
            print(f"  Port:      {args.port}", file=err)
            if args.loopback:
                print("  Mode:      Loopback (mod→demod→return)", file=err)
                if rewrite_bytes:
                    print(f"  Repeater:  {args.rewrite_callsign} (callsign rewrite)",
                          file=err)
            elif args.tx_mode:
                print("  Mode:      TX (IQ → stdout for PlutoSDR)", file=err)
            else:
                print("  Mode:      Monitor only", file=err)
        if args.iq_file:
            print(f"  IQ File:   {args.iq_file}", file=err)
        print("", file=err)

    running = [True]

    def on_sig(sig, frm):
        running[0] = False

    # restored on return, so an in-process caller keeps its own handlers
    old = {sig: signal.signal(sig, on_sig)
           for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    except (AttributeError, ValueError):
        pass
    try:
        if args.rx_mode:
            return _rx(args, dev, running)
        return _serve(args, dev, running, rewrite_bytes)
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)


def _rx(args, dev, running) -> int:
    """RX mode: stdin IQ -> demod -> UDP (opv-modem.cpp:673-838)."""
    from opv_tpu_torch.core.base40 import base40_decode
    from opv_tpu_torch.io.iq import iq_bytes_to_complex
    err = sys.stderr
    frames_rx = 0
    tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dest = ("127.0.0.1", args.response_port)
    sd = _Demod(args.fast, dev)
    if not args.quiet:
        print("✓ Receiving from stdin...\n", file=err)
    stdin = sys.stdin.buffer

    def handle(frames):
        nonlocal frames_rx
        for fbytes in frames:
            frames_rx += 1
            if args.verbose:
                sid = base40_decode(fbytes[:6])
                tok = int.from_bytes(fbytes[6:9], "big")
                print(f"RX {frames_rx}: {sid} [0x{tok:x}]", file=err)
            tx_sock.sendto(fbytes, dest)

    while running[0]:
        buf = stdin.read(16384)
        if not buf:
            break
        handle(sd.feed(iq_bytes_to_complex(buf)))
    handle(sd.flush())
    tx_sock.close()
    if not args.quiet:
        print("\n" + _RULE, file=err)
        print(f"Summary:\n  RX:  {frames_rx} frames", file=err)
        print(_RULE, file=err)
    return 0


def _serve(args, dev, running, rewrite_bytes: bytes) -> int:
    """TX, loopback and monitor: the UDP server loop
    (opv-modem.cpp:840-1006)."""
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.core.base40 import base40_decode
    from opv_tpu_torch.core.framing import encode_frame
    from opv_tpu_torch.io.udp import UDPFrameBridge
    from opv_tpu_torch.tx.modulator import (mod_reset, modulate_frames,
                                            tx_flush_zeros)
    err = sys.stderr
    try:
        bridge = UDPFrameBridge(port=args.port)
    except OSError:
        print(f"Error binding to port {args.port}", file=err)
        return 1

    sd = _Demod(args.fast, dev) if args.loopback else None
    mod_state = mod_reset()
    exact = not args.fast
    frames_tx = frames_rx = 0
    iq_out = open(args.iq_file, "wb") if args.iq_file else None

    if not args.quiet:
        print(f"✓ Listening on UDP port {args.port}...\n", file=err)

    def deliver(frames):
        nonlocal frames_rx
        for fbytes in frames:
            frames_rx += 1
            orig = base40_decode(fbytes[:6])
            if rewrite_bytes:
                if fbytes[:6] == rewrite_bytes:
                    if args.verbose:
                        print(f"SKIP {frames_rx}: already {args.rewrite_callsign}",
                              file=err)
                    continue
                fbytes = rewrite_bytes + fbytes[6:]
            if args.verbose:
                new = base40_decode(fbytes[:6])
                print(f"RX {frames_rx}: {orig} → {new}" if rewrite_bytes
                      else f"RX {frames_rx}: {new}", file=err)
            bridge.send(fbytes, response_port=args.response_port or None)

    while running[0]:
        for data in bridge.poll(timeout=0.1):
            frames_tx += 1
            if args.verbose:
                sid = base40_decode(data[:6])
                tok = int.from_bytes(data[6:9], "big")
                sender = bridge.last_sender
                print(f"TX {frames_tx}: {sid} [0x{tok:x}] from "
                      f"{sender[0]}:{sender[1]}", file=err)
            frame = torch.frombuffer(bytearray(data), dtype=torch.uint8)
            enc = encode_frame(frame.reshape(1, CONFIG.frame_bytes).to(dev))
            iq, mod_state = modulate_frames(enc, state=mod_state, exact=exact)
            iq_np = iq.cpu().numpy()
            wire = iq_np.astype("<i2").tobytes()
            if iq_out:
                iq_out.write(wire)
            if args.tx_mode:
                sys.stdout.buffer.write(wire)
                sys.stdout.buffer.flush()
            if sd is not None:
                # the locked engine takes the (n, 2) int16 wire pairs as
                # they are; the tracking demodulator makes them complex128
                deliver(sd.feed(iq_np))

    if sd is not None:
        # drain the frames still buffered in the engine (the tail can hold
        # the last frame's samples)
        deliver(sd.flush())
    bridge.close()
    if iq_out:
        iq_out.write(tx_flush_zeros().numpy().astype("<i2").tobytes())
        iq_out.close()
    if not args.quiet:
        print("\n" + _RULE, file=err)
        print(f"Summary:\n  TX:  {frames_tx} frames", file=err)
        if args.loopback:
            print(f"  RX:  {frames_rx} frames", file=err)
        print(_RULE, file=err)
    return 0

if __name__ == "__main__":
    sys.exit(main())
