"""MSK modulator: the closed-form fast path and the reference-exact path.

Fast path.  The gating state machine of the reference modulator reduces to
a bit-parity prefix (symbol_signs), and the waveform repeats every 160
samples (fs / f_dev = 160 exactly), so synthesis is one elementwise pass
over (S/4, 160) rows with a single (160,) sin/cos row:

    I[n] = (d_s2 - d_s1)[n // 40] * sin(2*pi*(n mod 160)/160)
    Q[n] = (d_s2 + d_s1)[n // 40] * cos(2*pi*(n mod 160)/160)

scaled by 16383 and truncated toward zero to int16, as the C++ cast.

Exact path (modulate_bits_exact).  The reference's two NCO phases are
accumulated serially in float64 with its per-sample wrap order
(opv-mod.cpp:262-280); that recurrence is the phase_track kernel
(ops/phase_track.py, csrc/phase_track.cu) on the card and a Python loop on
the host.  sin/cos, the tone mix, the scale and the cast follow in
float64 on the same device.  Its int16 output is the reference binary's
byte for byte (tests/golden/bert3.iq).

The first symbol after reset is silent (t_xor starts at 0).  Both paths
share one ModulatorState, and the fast path rewrites the float64 phases
from n160 after every call, so a stream may switch between the two."""

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
_PI = math.pi
_TWO_PI = 2.0 * math.pi
_INC1 = _TWO_PI * CONFIG.f1_freq / CONFIG.sample_rate
_INC2 = _TWO_PI * CONFIG.f2_freq / CONFIG.sample_rate


class ModulatorState(NamedTuple):
    """Modulator carry across frames of one stream, in the JAX package's
    field order: the gating state (t_xor in {-1, 0, +1}, b_n alternating),
    the two float64 NCO phases of the exact path and the sample index mod
    160 of the fast path.  Fields are python numbers or 0-d tensors."""
    t_xor: int | torch.Tensor
    b_n: int | torch.Tensor
    phase_f1: float | torch.Tensor
    phase_f2: float | torch.Tensor
    n160: int | torch.Tensor


def mod_reset() -> ModulatorState:
    return ModulatorState(t_xor=0, b_n=1, phase_f1=0.0, phase_f2=0.0, n160=0)


def _wrap_pi(p: torch.Tensor) -> torch.Tensor:
    p = torch.where(p > _PI, p - _TWO_PI, p)
    return torch.where(p < -_PI, p + _TWO_PI, p)


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
    n160_new = (n160 + s * _SPS % _PERIOD) % _PERIOD
    # the exact path's phases at the new n160 (mode interop), as the JAX
    # package computes them: wrap(-2pi/160 * n160) and wrap(+2pi/160 * n160)
    ph1 = -_TWO_PI / _PERIOD * n160_new.to(torch.float64)
    return wire, ModulatorState(t_f, bn_f, _wrap_pi(ph1), _wrap_pi(-ph1),
                                n160_new)


def modulate_bits_fast(bits: torch.Tensor, state: ModulatorState):
    """(S,) bits -> ((S*40, 2) int16 I/Q, new state): a view of the wire
    words (low half = I on little-endian hosts and GPUs)."""
    wire, new_state = modulate_bits_wire(bits, state)
    return wire.view(torch.int16).reshape(-1, 2), new_state


def modulate_bits_exact(bits: torch.Tensor, state: ModulatorState):
    """(S,) bits -> ((S*40, 2) int16 I/Q, new state), bit-identical to the
    reference binary: the serial float64 phase recurrence of both tones
    (registry.phase_track: the kernel on a CUDA device, the twin on the
    CPU), then I = a1 sin(ph1) + a2 sin(ph2), Q = a1 cos(ph1) + a2 cos(ph2)
    in float64, scaled by 16383 and truncated toward zero."""
    from opv_tpu_torch.ops import registry
    d_s1, d_s2, t_f, bn_f = symbol_signs(bits, state.t_xor, state.b_n)
    dev = d_s1.device
    n = bits.shape[0] * _SPS
    f64 = dict(dtype=torch.float64, device=dev)
    ph0 = torch.stack([torch.as_tensor(state.phase_f1, **f64),
                       torch.as_tensor(state.phase_f2, **f64)])
    phases, final = registry.phase_track(ph0, (_INC1, _INC2), n)
    sin, cos = _sincos(phases)
    a1 = d_s1.repeat_interleave(_SPS).to(torch.float64)
    a2 = d_s2.repeat_interleave(_SPS).to(torch.float64)
    i_sig = a1 * sin[0] + a2 * sin[1]
    q_sig = a1 * cos[0] + a2 * cos[1]
    iq16 = (torch.stack([i_sig, q_sig], dim=-1) * _AMP).to(torch.int16)
    n160 = torch.as_tensor(state.n160, dtype=torch.int32, device=dev)
    n160_new = (n160 + n % _PERIOD) % _PERIOD
    return iq16, ModulatorState(t_f, bn_f, final[0], final[1], n160_new)


def _sincos(phases: torch.Tensor):
    """float64 sin and cos of the phases.  On the card: torch's (CUDA's
    libdevice).  On the CPU: the C library's (math.sin / math.cos), which
    the reference binary calls; torch's CPU sin is not the same float64
    function from run to run (its vectorized paths return 1.0 - 2^-53
    instead of 1.0 near +-pi/2 in some runs, which flips a +-16383 sample
    to +-16382)."""
    if phases.is_cuda:
        return torch.sin(phases), torch.cos(phases)
    rows = phases.tolist()
    f64 = dict(dtype=torch.float64)
    return (torch.tensor([list(map(math.sin, r)) for r in rows], **f64),
            torch.tensor([list(map(math.cos, r)) for r in rows], **f64))


def modulate_frames(encoded_frames: torch.Tensor,
                    state: ModulatorState | None = None, exact: bool = False):
    """(F, 2144) encoded frames -> ((F*2168*40, 2) int16, final state) as
    one continuous stream with a sync word before each frame; exact=True
    runs the reference-exact float64 path, else the fast path."""
    from opv_tpu_torch.core.framing import frame_to_symbol_bits
    if state is None:
        state = mod_reset()
    stream = frame_to_symbol_bits(encoded_frames).reshape(-1)
    fn = modulate_bits_exact if exact else modulate_bits_fast
    return fn(stream, state)


def tx_flush_zeros(n_symbols: int = 100, device=None) -> torch.Tensor:
    """The trailing zero-IQ flush the reference modulator emits at end of
    stream: (n_symbols*40, 2) int16 zeros."""
    return torch.zeros((n_symbols * _SPS, 2), dtype=torch.int16, device=device)


def iq_int16_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2) int16 -> (...,) complex64, sample = I + jQ."""
    return torch.complex(iq[..., 0].to(torch.float32),
                         iq[..., 1].to(torch.float32))
