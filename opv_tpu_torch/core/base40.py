"""Base-40 callsign codec (host-side metadata, plain Python).

Callsign <-> 6-byte big-endian base-40 value with the first character in
the least-significant digit; unknown characters encode as digit 0, which
decodes to nothing, and the all-zero value decodes to "(empty)" — the same
quirks as opv_tpu.core.base40."""

from __future__ import annotations

_CHARSET_REV = {}
for _i in range(26):
    _CHARSET_REV[chr(ord("A") + _i)] = _i + 1
    _CHARSET_REV[chr(ord("a") + _i)] = _i + 1
for _i in range(10):
    _CHARSET_REV[chr(ord("0") + _i)] = _i + 27
_CHARSET_REV.update({"-": 37, "/": 38, ".": 39})


def _digit_to_char(d: int) -> str:
    if d == 0:
        return ""
    if d <= 26:
        return chr(ord("A") + d - 1)
    if d <= 36:
        return chr(ord("0") + d - 27)
    return {37: "-", 38: "/", 39: "."}[d]


def base40_encode(callsign: str) -> bytes:
    """Callsign -> 6-byte big-endian value (first char = lowest digit)."""
    value = 0
    for c in reversed(callsign):
        value = value * 40 + _CHARSET_REV.get(c, 0)
    return bytes((value >> (8 * (5 - i))) & 0xFF for i in range(6))


def base40_decode(data) -> str:
    """6-byte big-endian station ID -> callsign."""
    value = 0
    for b in data[:6]:
        value = (value << 8) | int(b)
    out = []
    while value > 0:
        out.append(_digit_to_char(value % 40))
        value //= 40
    return "".join(out) or "(empty)"
