"""67x32 block interleaver as precomputed permutation tables.

Bit i of the encoded stream lands at
    pos  = (i % 32) * 67 + i // 32
    dest = (pos // 8) * 8 + (7 - pos % 8)      (per-byte bit reversal)."""

from __future__ import annotations

import functools

import numpy as np

from opv_tpu_torch.config import CONFIG


@functools.lru_cache(maxsize=None)
def _scatter_map(n: int = CONFIG.encoded_bits) -> np.ndarray:
    i = np.arange(n)
    pos = ((i % CONFIG.interleave_cols) * CONFIG.interleave_rows
           + i // CONFIG.interleave_cols)
    return (pos // 8) * 8 + (7 - pos % 8)


@functools.lru_cache(maxsize=None)
def interleave_perm(n: int = CONFIG.encoded_bits) -> np.ndarray:
    """Gather table P with out = in[P] (TX interleaving)."""
    dest = _scatter_map(n)
    inv = np.empty(n, dtype=np.int32)
    inv[dest] = np.arange(n, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def deinterleave_gather(n: int = CONFIG.encoded_bits) -> np.ndarray:
    """Gather table D with deint = received[D] (RX deinterleaving)."""
    return _scatter_map(n).astype(np.int32)
