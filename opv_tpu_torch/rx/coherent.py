"""Coherent MSK demodulator (decision-directed Costas loop), counterpart of
opv_tpu/rx/coherent.py and of the reference's CoherentMSKDemodulator
(src/opv-demod.cpp:365-572): a fixed symbol grid (no timing recovery),
per-sample carrier de-rotation advancing by the loop frequency, soft
decision Re(corr_f2) - Re(corr_f1), a second-order PLL (alpha/beta from
the -p bandwidth at zeta 0.707) and the same AFC side loop.

The reference's coherent mode does not work (its AFC rails at +2000 Hz and
no frame decodes on clean IQ); this port reproduces it for parity.

The loop is plain torch: one step per symbol on (40,) tensors of the
samples' device, in the state's precision (float64 by default), with no
value read back to the host inside the loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opv_tpu_torch.config import CONFIG

_TWO_PI = 2.0 * math.pi
_PI = math.pi
_SPS = CONFIG.samples_per_symbol


class CoherentState(NamedTuple):
    """The loop carry, 0-d tensors in opv_tpu's field order."""
    freq_offset: torch.Tensor   # Hz, the AFC's
    carrier_phase: torch.Tensor
    phase_f1: torch.Tensor
    phase_f2: torch.Tensor
    loop_freq: torch.Tensor     # the PLL's frequency, rad per sample
    prev_dom: torch.Tensor      # complex dominant-tone correlation


def coherent_state_init(freq_offset=0.0, dtype=torch.float64,
                        device="cpu") -> CoherentState:
    """Zeros with the given offset (a number or a 0-d tensor)."""
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    z = torch.zeros((), dtype=dtype, device=device)
    return CoherentState(
        torch.as_tensor(freq_offset, dtype=dtype, device=device).reshape(()),
        z, z.clone(), z.clone(), z.clone(),
        torch.zeros((), dtype=cdtype, device=device))


def pll_gains(pll_bw_hz: float):
    """-p bandwidth -> (alpha, beta), opv-demod.cpp:554-561."""
    wn = pll_bw_hz * _TWO_PI
    zeta = 0.707
    return (2.0 * zeta * wn / CONFIG.symbol_rate,
            wn * wn / (CONFIG.symbol_rate ** 2))


def _wrap_pi(p: torch.Tensor) -> torch.Tensor:
    p = torch.where(p > _PI, p - _TWO_PI, p)
    return torch.where(p < -_PI, p + _TWO_PI, p)


def _rot(phase: torch.Tensor) -> torch.Tensor:
    """e^{-j phase}."""
    return torch.polar(torch.ones_like(phase), -phase)


def demodulate_coherent(samples: torch.Tensor, state: CoherentState,
                        afc_alpha: float, pll_alpha: float, pll_beta: float):
    """(N,) complex -> ((N // 40,) soft, final state), on the samples'
    device in the state's precision.  The AFC is held on the call's first
    symbol."""
    rdtype = state.freq_offset.dtype
    cdtype = state.prev_dom.dtype
    dev = samples.device
    nsym = samples.shape[0] // _SPS
    sym = samples[: nsym * _SPS].reshape(nsym, _SPS).to(cdtype)
    i40 = torch.arange(_SPS, dtype=rdtype, device=dev)
    fd, fs, sr = CONFIG.freq_dev, CONFIG.sample_rate, CONFIG.symbol_rate
    clamp = CONFIG.afc_clamp_hz
    foff, cp, ph1, ph2, lf, pdom = (t.to(dev) for t in state)
    soft = torch.empty(nsym, dtype=rdtype, device=dev)
    for k in range(nsym):
        inc1 = _TWO_PI * (-fd + foff) / fs
        inc2 = _TWO_PI * (fd + foff) / fs
        corrected = sym[k] * _rot(cp + i40 * lf)
        c1 = (corrected * _rot(ph1 + i40 * inc1)).sum()
        c2 = (corrected * _rot(ph2 + i40 * inc2)).sum()
        ph1 = _wrap_pi(ph1 + _SPS * inc1)
        ph2 = _wrap_pi(ph2 + _SPS * inc2)
        cpn = _wrap_pi(cp + _SPS * lf)

        e1 = c1.real ** 2 + c1.imag ** 2
        e2 = c2.real ** 2 + c2.imag ** 2
        soft[k] = c2.real - c1.real
        dom = torch.where(e1 > e2, c1, c2)
        mag = dom.abs()
        pe = torch.where(mag > 1e-10, dom.imag / mag, torch.zeros_like(mag))
        lf = torch.clamp(lf + pll_beta * pe, -0.1, 0.1)
        cp = cpn + pll_alpha * pe

        if k > 0:
            ferr = torch.angle(dom * pdom.conj()) * sr / _TWO_PI
            foff = torch.clamp(foff + afc_alpha * ferr, -clamp, clamp)
        pdom = dom
    return soft, CoherentState(foff, cp, ph1, ph2, lf, pdom)
