"""Human-readable frame display (counterpart of opv_tpu/utils/display.py,
string for string).

The reference's stderr formats (box-drawing frame dump,
opv-demod.cpp:907-938), so operators and log parsers see familiar output.
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
