"""Dense correlator bank and dilated sync correlation (acquisition).

dense_soft evaluates the locked-grid tone correlation at all 40 sample
phases with one real (C, M+1, 80) x (C, 80, 40*8) contraction; dense_sync
correlates the 24-symbol sync pattern against that stream at dilation 40
as 24 shifted, scaled adds in exact float32 (no convolution library, so no
TF32 on the card)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.sync import normalized_sync, sync_pattern

_TWO_PI = 2.0 * math.pi
_SPS = CONFIG.samples_per_symbol
_SB = CONFIG.sync_bits


def tone_vectors(freq_offset: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C,) Hz -> ((C, 40, 2) complex64 e^{-j inc t} per tone,
    (C, 2) float32 phase increments per sample)."""
    f = freq_offset.to(torch.float32)
    freqs = torch.stack([-CONFIG.freq_dev + f, CONFIG.freq_dev + f], dim=-1)
    incs = np.float32(_TWO_PI / CONFIG.sample_rate) * freqs
    t = torch.arange(_SPS, dtype=torch.float32, device=f.device)
    ph = incs[:, None, :] * t[None, :, None]
    return torch.complex(torch.cos(ph), -torch.sin(ph)), incs


def phase_rot(incs: torch.Tensor) -> torch.Tensor:
    """(C, 2) -> (C, 2) complex64 e^{-j inc 40}: the one-symbol phase
    advance that joins a window's tail (A) and head (B) halves."""
    ph = incs * _SPS
    return torch.complex(torch.cos(ph), -torch.sin(ph))


def real_columns(kern: torch.Tensor) -> torch.Tensor:
    """(C, 40, ..., 4) complex -> (C, 80, ..., 8) real: row 2t multiplies
    the I sample, row 2t+1 the Q sample; columns [Re x4, Im x4] of the
    complex product."""
    kr, ki = kern.real, kern.imag
    out = torch.stack([torch.cat([kr, ki], -1), torch.cat([-ki, kr], -1)],
                      dim=2)
    return out.reshape(kern.shape[0], 2 * _SPS, *kern.shape[2:-1], 8)


def combine(ab: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(C, M+1, ..., 8) window correlations -> (C, M, ...) soft values
    |A_2(s) + phi_2 B_2(s+1)|^2 - |A_1(s) + phi_1 B_1(s+1)|^2."""
    a_re, b_re = ab[:, :-1, ..., 0:2], ab[:, 1:, ..., 2:4]
    a_im, b_im = ab[:, :-1, ..., 4:6], ab[:, 1:, ..., 6:8]
    shape = (phi.shape[0],) + (1,) * (ab.dim() - 2) + (2,)
    p_re, p_im = phi.real.reshape(shape), phi.imag.reshape(shape)
    c_re = a_re + p_re * b_re - p_im * b_im
    c_im = a_im + p_re * b_im + p_im * b_re
    p = c_re ** 2 + c_im ** 2
    return p[..., 1] - p[..., 0]


def require_single_precision(samples: torch.Tensor, where: str) -> None:
    """Refuse float64 / complex128 samples.  The JAX package computes such
    input in float64 end to end; the port has only the float32 path, and a
    silently narrowed result would be a different result."""
    if samples.dtype in (torch.complex128, torch.float64):
        raise ValueError(
            f"{where}: {samples.dtype} samples need the float64 receiver "
            "path, which the port does not have yet (ROADMAP queue 1, item "
            "11); convert the input to complex64 (or float32 pairs) first")


def dense_soft(samples: torch.Tensor, freq_offset: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """(C, N) complex64 -> soft decision at every `stride`-th sample offset,
    (C, (N-40)//stride + 1); position u is sample offset stride*u."""
    require_single_precision(samples, "dense_soft")
    c, n = samples.shape
    m2 = -(-n // _SPS)
    x = F.pad(torch.view_as_real(samples), (0, 0, 0, (m2 + 1) * _SPS - n))
    sym_f = x.reshape(c, m2 + 1, 2 * _SPS)
    e, incs = tone_vectors(freq_offset)                     # (C, 40, 2)
    ar = torch.arange(_SPS, device=samples.device)
    mask_a = (ar[:, None] >= ar[None, :])[None, :, :, None]     # (1, t, r, 1)
    ea = e[:, :, None, :]
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    kern = torch.cat([torch.where(mask_a, ea, zero),
                      torch.where(mask_a, zero, ea)], -1)   # (C, 40, 40, 4)
    kern_f = real_columns(kern)                            # (C, 80, 40, 8)
    if stride > 1:
        kern_f = kern_f[:, :, ::stride, :]
    n_ph = _SPS // stride
    ab = torch.einsum("cst,ctro->csro", sym_f, kern_f)    # (C, M+1, ph, 8)
    soft = combine(ab, phase_rot(incs)).reshape(c, m2 * n_ph)
    return soft[:, : (n - _SPS) // stride + 1]


def dense_sync(soft: torch.Tensor, stride: int = 1):
    """Dilated 24-tap sync correlation at every dense soft position:
    (C, M) -> (raw, norm), each (C, M - 23*40/stride)."""
    dil = _SPS // stride
    length = soft.shape[-1] - (_SB - 1) * dil
    pat = sync_pattern()
    mag = soft.abs()
    raw = torch.zeros_like(soft[:, :length])
    energy = torch.zeros_like(raw)
    for i in range(_SB):
        w = soft[:, i * dil: i * dil + length]
        raw = raw + w if pat[i] > 0 else raw - w
        energy = energy + mag[:, i * dil: i * dil + length]
    return raw, normalized_sync(raw, energy)
