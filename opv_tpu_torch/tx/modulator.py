"""MSK modulator, closed-form fast path.

The gating state machine of the reference modulator reduces to a bit-parity
prefix (symbol_signs), and the waveform repeats every 160 samples
(fs / f_dev = 160 exactly), so synthesis is one elementwise pass over
(S/4, 160) rows with a single (160,) sin/cos row:

    I[n] = (d_s2 - d_s1)[n // 40] * sin(2*pi*(n mod 160)/160)
    Q[n] = (d_s2 + d_s1)[n // 40] * cos(2*pi*(n mod 160)/160)

scaled by 16383 and truncated toward zero to int16, as the C++ cast.
The first symbol after reset is silent (t_xor starts at 0)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG

_SPS = CONFIG.samples_per_symbol
_PERIOD = 160
_AMP = CONFIG.iq_amplitude
_TWO_PI = 2.0 * math.pi


class ModulatorState(NamedTuple):
    """Modulator carry across frames of one stream: the gating state
    (t_xor in {-1, 0, +1}, b_n alternating) and the sample index mod 160.
    Fields are python ints or 0-d int tensors."""
    t_xor: int | torch.Tensor
    b_n: int | torch.Tensor
    n160: int | torch.Tensor


def mod_reset() -> ModulatorState:
    return ModulatorState(t_xor=0, b_n=1, n160=0)


def symbol_signs(bits: torch.Tensor, t_xor, b_n):
    """Gating state machine over (S,) bits, in closed form.

    t' = (t == 0) ? 1 : (1 - 2b) * t makes the t used at symbol k a parity
    prefix of the bits; b_n alternates.  Returns (d_s1, d_s2) int32 (S,)
    in {-1, 0, 1} and the final (t_xor, b_n) carry as 0-d tensors."""
    bits = bits.to(torch.int32)
    dev = bits.device
    t_xor = torch.as_tensor(t_xor, dtype=torch.int32, device=dev)
    b_n = torch.as_tensor(b_n, dtype=torch.int32, device=dev)
    s = bits.shape[0]
    if s == 0:
        return bits, bits, t_xor, b_n
    k = torch.arange(s, dtype=torch.int32, device=dev)
    incl = torch.cumsum(bits, 0, dtype=torch.int32)
    excl = incl - bits
    t_nz = t_xor * (1 - 2 * (excl & 1))
    t_z = torch.where(k == 0, 0, 1 - 2 * ((excl - bits[0]) & 1))
    t_k = torch.where(t_xor == 0, t_z, t_nz)
    bn_k = torch.where((k & 1) == 0, b_n, 1 - b_n)
    d_s1 = (1 - bits) * t_k
    d_s2 = torch.where(bn_k == 0, -bits, bits) * t_k
    tot = incl[-1]
    t_f = torch.where(t_xor == 0, 1 - 2 * ((tot - bits[0]) & 1),
                      t_xor * (1 - 2 * (tot & 1)))
    bn_f = b_n if s % 2 == 0 else 1 - b_n
    return (d_s1.to(torch.int32), d_s2.to(torch.int32),
            t_f.to(torch.int32), bn_f.to(torch.int32))


def modulate_bits_wire(bits: torch.Tensor, state: ModulatorState):
    """(S,) bits -> ((S*40,) int32 wire words, new state).

    word = (Q << 16) | (I & 0xFFFF): each word's little-endian bytes are
    one int16 I/Q wire sample."""
    d_s1, d_s2, t_f, bn_f = symbol_signs(bits, state.t_xor, state.b_n)
    dev = d_s1.device
    s = bits.shape[0]
    n160 = torch.as_tensor(state.n160, dtype=torch.int32, device=dev)
    j = torch.arange(_PERIOD, dtype=torch.int32, device=dev)
    k = (n160 + j) % _PERIOD
    ph = k.to(torch.float32) * np.float32(_TWO_PI / _PERIOD)
    sin_t, cos_t = torch.sin(ph), torch.cos(ph)
    pad = (-s) % 4
    d_s1 = F.pad(d_s1, (0, pad))
    d_s2 = F.pad(d_s2, (0, pad))
    a1 = d_s1.reshape(-1, 4).repeat_interleave(_SPS, dim=1).to(torch.float32)
    a2 = d_s2.reshape(-1, 4).repeat_interleave(_SPS, dim=1).to(torch.float32)
    i16 = ((a2 - a1) * sin_t * np.float32(_AMP)).to(torch.int16)
    q16 = ((a2 + a1) * cos_t * np.float32(_AMP)).to(torch.int16)
    wire = (q16.to(torch.int32) << 16) | (i16.to(torch.int32) & 0xFFFF)
    wire = wire.reshape(-1)[: s * _SPS]
    return wire, ModulatorState(t_f, bn_f, (n160 + s * _SPS) % _PERIOD)


def modulate_bits_fast(bits: torch.Tensor, state: ModulatorState):
    """(S,) bits -> ((S*40, 2) int16 I/Q, new state): a view of the wire
    words (low half = I on little-endian hosts and GPUs)."""
    wire, new_state = modulate_bits_wire(bits, state)
    return wire.view(torch.int16).reshape(-1, 2), new_state


def modulate_frames(encoded_frames: torch.Tensor,
                    state: ModulatorState | None = None, exact: bool = False):
    """(F, 2144) encoded frames -> ((F*2168*40, 2) int16, final state) as
    one continuous stream with a sync word before each frame."""
    from opv_tpu_torch.core.framing import frame_to_symbol_bits
    if exact:
        raise NotImplementedError(
            "the float64 reference-exact modulator is not ported; "
            "use exact=False")
    if state is None:
        state = mod_reset()
    stream = frame_to_symbol_bits(encoded_frames).reshape(-1)
    return modulate_bits_fast(stream, state)


def tx_flush_zeros(n_symbols: int = 100, device=None) -> torch.Tensor:
    """The trailing zero-IQ flush the reference modulator emits at end of
    stream: (n_symbols*40, 2) int16 zeros."""
    return torch.zeros((n_symbols * _SPS, 2), dtype=torch.int16, device=device)


def iq_int16_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 -> (...,) complex64, sample = I + jQ."""
    return torch.complex(iq[..., 0].to(torch.float32),
                         iq[..., 1].to(torch.float32))
