"""Frame codec chain on tensors.

TX: randomize -> conv-encode (byte 133 first, MSB-first bits) -> interleave.
RX finishing: pack the Viterbi bits in reverse byte order -> derandomize.
Shape-polymorphic over leading batch axes; the tables live on the input's
device, copied there once (device_table)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.base40 import base40_encode
from opv_tpu_torch.core.convcode import conv_encode_bits
from opv_tpu_torch.core.interleave import interleave_perm
from opv_tpu_torch.core.lfsr import randomizer_mask

_SHIFTS_MSB = (7, 6, 5, 4, 3, 2, 1, 0)


@functools.lru_cache(maxsize=None)
def device_table(make, device: torch.device, dtype=None) -> torch.Tensor:
    """The constant host table make() on `device` (cast to `dtype`), copied
    there once and kept: a copy from pageable host memory to the card
    synchronizes the stream, so a table copied per call would make every
    call wait for the work queued before it.  Callers only read it."""
    return torch.from_numpy(np.ascontiguousarray(make())).to(device, dtype)


def bytes_to_bits_msb(b: torch.Tensor) -> torch.Tensor:
    """(..., B) uint8 -> (..., 8B) bits, MSB first within each byte."""
    sh = torch.tensor(_SHIFTS_MSB, dtype=torch.uint8, device=b.device)
    bits = (b.to(torch.uint8)[..., :, None] >> sh) & 1
    return bits.reshape(*b.shape[:-1], b.shape[-1] * 8)


def bits_to_bytes_msb(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8B) bits -> (..., B) uint8, MSB first within each byte."""
    g = bits.to(torch.int32).reshape(*bits.shape[:-1], -1, 8)
    w = 1 << torch.tensor(_SHIFTS_MSB, dtype=torch.int32, device=bits.device)
    return (g * w).sum(-1).to(torch.uint8)


def randomize(payload: torch.Tensor) -> torch.Tensor:
    """XOR-whiten a (..., 134) frame; the mask XOR is its own inverse."""
    return payload.to(torch.uint8) ^ device_table(randomizer_mask,
                                                  payload.device)


derandomize = randomize


def encode_frame(payload: torch.Tensor) -> torch.Tensor:
    """(..., 134) uint8 payload -> (..., 2144) encoded + interleaved bits."""
    rnd = randomize(payload)
    u = bytes_to_bits_msb(rnd.flip(-1))
    enc = conv_encode_bits(u)
    return enc[..., device_table(interleave_perm, enc.device, torch.int64)]


def pack_frame_bits(bits: torch.Tensor) -> torch.Tensor:
    """Viterbi bits (..., 1072) -> (..., 134) bytes: packed[i] bit j =
    bits[1071 - 8i - j] (LSB-first bytes of the reversed stream)."""
    g = bits.flip(-1).to(torch.int32).reshape(*bits.shape[:-1], -1, 8)
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (g * w).sum(-1).to(torch.uint8)


def frame_to_symbol_bits(encoded: torch.Tensor) -> torch.Tensor:
    """Prepend the 24-bit sync word (MSB first): (..., 2144) -> (..., 2168)."""
    sync = torch.tensor(CONFIG.sync_pattern_bits(), dtype=torch.uint8,
                        device=encoded.device)
    sync = sync.expand(*encoded.shape[:-1], CONFIG.sync_bits)
    return torch.cat([sync, encoded.to(torch.uint8)], dim=-1)


def build_bert_frame(callsign: str, token: int = CONFIG.default_token,
                     frame_num=0) -> np.ndarray:
    """BERT test frame(s): station ID, token, then a counting payload.
    frame_num may be a (B,) array for a (B, 134) batch.  Host-side numpy:
    the frames are tiny and the caller moves them to its device."""
    fn = np.atleast_1d(np.asarray(frame_num, dtype=np.int64))
    frame = np.zeros((fn.shape[0], CONFIG.frame_bytes), dtype=np.uint8)
    frame[:, :6] = np.frombuffer(base40_encode(callsign), dtype=np.uint8)
    frame[:, 6] = (token >> 16) & 0xFF
    frame[:, 7] = (token >> 8) & 0xFF
    frame[:, 8] = token & 0xFF
    idx = np.arange(CONFIG.frame_bytes - CONFIG.payload_offset, dtype=np.int64)
    frame[:, CONFIG.payload_offset:] = ((fn[:, None] + idx[None, :]) & 0xFF
                                        ).astype(np.uint8)
    if np.asarray(frame_num).ndim == 0:
        return frame[0]
    return frame
