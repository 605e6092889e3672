"""Human-readable frame display (counterpart of opv_tpu/utils/display.py,
string for string).

The reference's stderr formats (box-drawing frame dump,
opv-demod.cpp:907-938; periodic status line, opv-demod.cpp:1079-1083; sync
transition lines, opv-demod.cpp:651-706), so operators and log parsers see
familiar output.
Each function writes to `out`, sys.stderr at the time of the call by
default.
"""

from __future__ import annotations

import sys

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.base40 import base40_decode

_RULE = "════════════════════════════════════════════════════════════════════"


def banner(title: str, out=None) -> None:
    out = out or sys.stderr
    print("╔═══════════════════════════════════════════════════════════════════╗",
          file=out)
    print(f"║ {title:^65} ║", file=out)
    print("╚═══════════════════════════════════════════════════════════════════╝\n",
          file=out)


def print_frame(num: int, frame: bytes, metric: int, sync_corr: float,
                out=None) -> None:
    out = out or sys.stderr
    f = bytes(frame)
    w = out.write
    w("┌─────────────────────────────────────────────────────────────────┐\n")
    w(f"│ FRAME {num:4d}  │  Sync: {sync_corr:.3f}  │  Metric: {metric:5d}")
    if metric == 0:
        w(" (perfect)")
    w("\n├─────────────────────────────────────────────────────────────────┤\n")
    w(f"│ Station ID:  {base40_decode(f[:6]):<12} (Base-40)\n")
    tok = (f[6] << 16) | (f[7] << 8) | f[8]
    w(f"│ Token:       0x{tok:06X}"
      f"{' (default)' if tok == CONFIG.default_token else ''}\n")
    res = (f[9] << 16) | (f[10] << 8) | f[11]
    w(f"│ Reserved:    0x{res:06X}\n")
    w("├─────────────────────────────────────────────────────────────────┤\n")
    w("│ Hex Dump:                                                       │\n")
    n = CONFIG.frame_bytes
    for i in range(0, n, 16):
        w(f"│ {i:02x}: ")
        for j in range(i, i + 16):
            w(f"{f[j]:02X} " if j < n else "   ")
        w(" │")
        for j in range(i, min(i + 16, n)):
            w(chr(f[j]) if 0x20 <= f[j] < 0x7F else ".")
        w("│\n")
    w("└─────────────────────────────────────────────────────────────────┘\n\n")
    out.flush()


def summary(decoded: int, perfect: int, seconds: float, symbols: int,
            state: str, afc_hz: float, out=None) -> None:
    out = out or sys.stderr
    print("\n" + _RULE, file=out)
    print(f"Summary: {decoded} frames ({perfect} perfect, "
          f"{decoded - perfect} errors)", file=out)
    print(f"Total: {seconds:.3f} sec, {symbols} symbols", file=out)
    print(f"Final state: {state}, AFC: {afc_hz:.1f} Hz", file=out)
    print(_RULE, file=out)


def status_line(seconds: float, symbols: int, decoded: int, perfect: int,
                afc_hz: float, timing_freq: float, out=None) -> None:
    print(f"[{seconds:.1f}s] {symbols} symbols, {decoded} frames "
          f"({perfect} perfect), AFC: {afc_hz:.1f} Hz, TFreq: {timing_freq:.4f}",
          file=out or sys.stderr)


def print_sync_event(sym_idx: int, code: int, norm: float, raw: float,
                     misses: int, frames: int, out=None) -> None:
    """One sync-lifecycle transition line, byte for byte the reference's
    stderr format (src/opv-demod.cpp:651-706).  code: an rx.sync.EV_*
    value; EV_LOSE_LOCK prints the MISS line and the lost-lock line, as
    the reference does."""
    out = out or sys.stderr
    if code == 1:
        print(f"[{sym_idx}] HUNTING→VERIFYING (corr={norm:.3f}, raw={raw:.0f})",
              file=out)
    elif code == 2:
        print(f"[{sym_idx}] VERIFYING→LOCKED (frame {frames})", file=out)
    elif code == 3:
        print(f"[{sym_idx}] LOCKED: sync OK (corr={norm:.3f})", file=out)
    elif code in (4, 5):
        print(f"[{sym_idx}] LOCKED: sync MISS #{misses} (corr={norm:.3f})",
              file=out)
        if code == 5:
            print(f"[{sym_idx}] LOCKED→HUNTING (lost lock)", file=out)
