"""The feed-forward dense receiver (counterpart of opv_tpu/rx/fast.py):
the dense correlator bank, the dilated sync correlation, frame detection
and the payload gather, and rx_fast, which chains them with the CFO grid
and the frame finisher.

dense_soft evaluates the locked-grid tone correlation at all 40 sample
phases with one real (C, M+1, 80) x (C, 80, 40*8) contraction; dense_sync
correlates the 24-symbol sync pattern against that stream at dilation 40
as 24 shifted, scaled adds in exact float32 (no convolution library, so no
TF32 on the card).  complex128 samples run every stage in float64, as the
JAX package computes them.  detect_frames keeps the first max_frames qualifying
sync peaks of each channel by a cumulative count on the device, so a block
runs from samples to decoded frames without a host round trip; the
Viterbi is one launch over every (channel, slot) payload."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.cfo import estimate_cfo_batch
from opv_tpu_torch.rx.sync import normalized_sync, sync_pattern

_TWO_PI = 2.0 * math.pi
_SPS = CONFIG.samples_per_symbol
_SB = CONFIG.sync_bits
_EB = CONFIG.encoded_bits


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


def double_precision(samples: torch.Tensor) -> bool:
    """complex128 samples (or float64 pairs or rows) take the float64 path,
    as the JAX package computes them."""
    return samples.dtype in (torch.complex128, torch.float64)


def tone_vectors_f64(incs: torch.Tensor) -> torch.Tensor:
    """(C, 2) float32 increments -> (C, 40, 2) complex128 e^{-j inc t},
    the phases taken in float64 from the float32 increments (the JAX
    package's dense correlator on complex128)."""
    inc = incs.to(torch.float64)
    t = torch.arange(_SPS, dtype=torch.float64, device=inc.device)
    ph = inc[:, None, :] * t[None, :, None]
    return torch.complex(torch.cos(ph), -torch.sin(ph))


def dense_soft(samples: torch.Tensor, freq_offset: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """(C, N) complex64 -> soft decision at every `stride`-th sample offset,
    (C, (N-40)//stride + 1); position u is sample offset stride*u.
    complex128 samples give float64 soft values."""
    c, n = samples.shape
    m2 = -(-n // _SPS)
    x = F.pad(torch.view_as_real(samples), (0, 0, 0, (m2 + 1) * _SPS - n))
    sym_f = x.reshape(c, m2 + 1, 2 * _SPS)
    e, incs = tone_vectors(freq_offset)                     # (C, 40, 2)
    if double_precision(samples):
        e, incs = tone_vectors_f64(incs), incs.to(torch.float64)
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


def detect_frames(raw: torch.Tensor, norm: torch.Tensor, soft: torch.Tensor,
                  max_frames: int):
    """Frame sync positions: threshold, tap-dominance guard, local max of
    the raw correlation over +-20 samples, timing-phase vote.

    raw/norm: (C, M) from dense_sync(soft); soft: the (C, M_soft) dense
    stream they came from.  Returns (starts (C, F) int32 sample index of the
    first payload soft value (a sync window at n has its payload at n +
    24*40), valid (C, F) bool, q (C, F) the normalized sync at the peak).
    The first F = max_frames qualifying positions of each row are kept in
    index order; an empty slot has start 959 (t = -1), valid False and q =
    norm[:, 0], opv_tpu's padding values.
    """
    c, m = norm.shape
    m_soft = soft.shape[-1]
    dev = soft.device
    hit = (norm >= CONFIG.sync_hunt_norm_thresh) & \
        (raw >= CONFIG.sync_hunt_raw_thresh)
    # tap-dominance guard: at a signal->silence edge a window holding one
    # strong soft symbol (the other 23 taps in the gap) clears both
    # thresholds; a true sync spreads its energy over all 24 taps.  The sum
    # is 24 shifted adds in tap order, the max an exact dilated max pool.
    mag = soft.abs()
    energy = torch.zeros_like(raw)
    for i in range(_SB):
        energy = energy + mag[:, i * _SPS: i * _SPS + m]
    amax = F.max_pool1d(mag[:, None], kernel_size=_SB, stride=1,
                        dilation=_SPS)[:, 0, :m]
    hit = hit & (amax <= 0.5 * energy)
    # the normalized metric saturates over a plateau around the true
    # alignment; the raw correlation peaks at the exact sample
    wmax = F.max_pool1d(raw[:, None], kernel_size=_SPS + 1, stride=1,
                        padding=_SPS // 2)[:, 0]
    prev = F.pad(raw, (1, 0), value=-math.inf)[:, :-1]
    is_peak = (raw >= wmax) & (raw > prev) & hit
    # timing-phase vote: a peak at the strongest peak's sample phase
    # (mod 40, +-1), or with a qualifying sync (+-1 sample) exactly one
    # frame before or after it (a second burst at another phase)
    n_idx = torch.arange(m, device=dev)
    best = torch.argmax(torch.where(is_peak, raw, -math.inf), dim=-1)
    dph = (n_idx[None, :] - (best % _SPS)[:, None]) % _SPS
    phase_ok = (dph <= 1) | (dph >= _SPS - 1)
    dil = hit.clone()
    dil[:, 1:] |= hit[:, :-1]
    dil[:, :-1] |= hit[:, 1:]
    spf = CONFIG.samples_per_frame
    if m > spf:
        phase_ok[:, : m - spf] |= dil[:, spf:]
        phase_ok[:, spf:] |= dil[:, : m - spf]
    # the payload must fit in the dense soft stream
    fits = n_idx + _SB * _SPS + (_EB - 1) * _SPS < m_soft
    mask = is_peak & phase_ok & fits[None, :]
    # the first max_frames positions of each row, as jnp.nonzero(size=F,
    # fill_value=-1): rank by a cumulative count, scatter; the overflow
    # column F is dropped
    rank = mask.to(torch.int64).cumsum(-1) - 1
    slot = torch.where(mask & (rank < max_frames), rank, max_frames)
    t = torch.full((c, max_frames + 1), -1, dtype=torch.int64, device=dev)
    t.scatter_(1, slot, n_idx.expand(c, m))
    t = t[:, :max_frames]
    q = norm.gather(1, t.clamp(min=0))
    return (t + _SB * _SPS).to(torch.int32), t >= 0, q


def extract_payloads_dense(soft: torch.Tensor, starts: torch.Tensor):
    """(C, F, 2144) payload soft symbols at stride 40 from (C, M) soft, each
    start clamped to [0, M - (2143*40 + 1)]."""
    c, f = starts.shape
    span = (_EB - 1) * _SPS + 1
    st = starts.to(torch.int64).clamp(0, soft.shape[-1] - span)
    cols = st[..., None] + _SPS * torch.arange(_EB, device=soft.device)
    return soft.gather(1, cols.reshape(c, -1)).reshape(c, f, _EB)


def rx_fast(samples: torch.Tensor, freq_offset=None, max_frames: int = 8,
            estimate_cfo_flag: bool = True) -> dict:
    """The feed-forward pipeline: (C, N) complex64 IQ -> decoded frames, on
    the samples' device (complex128 IQ in float64 throughout).

    Arbitrary symbol timing and frame positions (dense correlation), one
    CFO per channel and block (the grid estimate, or freq_offset (C,) Hz,
    or zero with estimate_cfo_flag=False).  Returns a dict of tensors:
    frames (C, F, 134) uint8, metrics (C, F) int32, frame_valid (C, F),
    sync_q (C, F), starts (C, F) int32 sample-resolution payload starts,
    freq_offset (C,) float32, n_decoded.
    """
    c, n = samples.shape
    min_n = _SB * _SPS + (_EB - 1) * _SPS + _SPS + (_SB - 1) * _SPS
    if n < min_n:
        raise ValueError(
            f"rx_fast needs at least one full frame of samples ({min_n}), "
            f"got {n}; short captures cannot contain a decodable frame")
    if freq_offset is None:
        if estimate_cfo_flag:
            freq_offset = estimate_cfo_batch(samples).to(torch.float32)
        else:
            freq_offset = torch.zeros(c, dtype=torch.float32,
                                      device=samples.device)
    else:
        freq_offset = torch.as_tensor(freq_offset, dtype=torch.float32,
                                      device=samples.device)
    # imported here: ops/ imports this module
    from opv_tpu_torch.rx.frame_decoder import decode_payloads
    soft = dense_soft(samples, freq_offset)
    raw, norm = dense_sync(soft)
    starts, valid, q = detect_frames(raw, norm, soft, max_frames)
    payloads = extract_payloads_dense(soft, starts)
    frames, metrics, ok = decode_payloads(payloads.reshape(-1, _EB))
    fv = ok.reshape(c, max_frames) & valid
    return dict(frames=frames.reshape(c, max_frames, CONFIG.frame_bytes),
                metrics=metrics.reshape(c, max_frames), frame_valid=fv,
                sync_q=q, starts=starts, freq_offset=freq_offset,
                n_decoded=fv.sum())
