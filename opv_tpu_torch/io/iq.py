"""Sample I/O: the int16 IQ wire format (counterpart of opv_tpu/io/iq.py).

Wire format per the reference (opv-mod.cpp:53, 304-309): interleaved
little-endian int16 (I, Q) pairs, full scale 16383.

numpy only.  The JAX package swaps in a C extension for complex64 on hot
paths; int16 -> float is exact, so both give the same values.
"""

from __future__ import annotations

import numpy as np


def iq_bytes_to_complex(buf: bytes | bytearray | memoryview,
                        dtype=np.complex128) -> np.ndarray:
    """Interleaved int16 LE bytes -> (N,) complex samples (I + jQ); a
    trailing partial sample is dropped."""
    nb = (len(buf) // 4) * 4
    a = np.frombuffer(buf[:nb] if nb != len(buf) else buf, dtype="<i2")
    return int16_pairs_to_complex(a.reshape(-1, 2), dtype)


def int16_pairs_to_complex(iq: np.ndarray, dtype=np.complex128) -> np.ndarray:
    """(N, 2) int16 -> (N,) complex."""
    return (iq[:, 0].astype(np.float64)
            + 1j * iq[:, 1].astype(np.float64)).astype(dtype)


def iq_bytes_to_i16_pairs(buf: bytes | bytearray | memoryview,
                          channels: int = 1) -> np.ndarray:
    """Interleaved int16 LE bytes -> (channels, N, 2) int16 IQ pairs, the
    wire form the locked engine takes as it is and casts on its device
    (int16 -> float32 is exact, so the rows equal those of the JAX
    package's iq_bytes_to_f32_pairs).  Multichannel streams interleave
    channel pairs per sample instant (I0 Q0 I1 Q1 ...), the framing of
    opv-demod --channels; a trailing partial instant is dropped.  The
    result is a strided view of a writable copy of the bytes."""
    quantum = 4 * channels
    nb = (len(buf) // quantum) * quantum
    a = np.frombuffer(bytearray(memoryview(buf)[:nb]), dtype="<i2")
    return a.reshape(-1, channels, 2).transpose(1, 0, 2)
