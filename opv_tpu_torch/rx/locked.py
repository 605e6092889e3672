"""Locked-grid multichannel receiver (batch form), on tensors.

A continuous OPV transmission places one frame every 86,720 samples at a
fixed sample phase, and 86,720 % 40 == 0, so every frame shares the timing
phase r = p0 mod 40.  The receiver therefore splits into:

  1. acquisition (rx_locked): coarse CFO grid + feed-forward refinement,
     dense tone correlation and dilated sync correlation over the first
     two frame intervals -> the first sync p0 per channel, then a deep
     fold of the dense sync correlation for sub-sample timing (frac);
  2. the steady body (_locked_body, also rx_locked_steady): the soft stage
     at the symbol grid only (ops.registry.symbol_soft — the fused CUDA
     kernel on the card), frame slicing + per-frame sync quality, and the
     batched Viterbi frame finisher (ops.registry.viterbi_batch);
  3. what the streaming engine (stream/locked.py) adds on top: selective
     re-acquisition of the channels that lost lock (rx_locked_reacquire)
     and the folded timing refresh of locked channels
     (refine_timing_locked, rx_locked_retime).

`samples` is (C, N) complex64, (C, N, 2) float I/Q pairs, or (C, M, 80)
window rows (row s = samples [40s, 40s+40) as interleaved I/Q) in float32
or int8 (values = wire samples / INT8_SCALE, or / a per-channel `scale`).
complex128 samples (and float64 pairs or rows) run in float64, as the JAX
package computes them: the soft stage's float64 instantiation, the dense
correlator, the sync correlations and the timing fold; the CFO stays the
float32 of the JAX package's grid and refinement.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.framing import device_table
from opv_tpu_torch.ops import registry
from opv_tpu_torch.rx.cfo import estimate_cfo_batch, needs_wide_sums
from opv_tpu_torch.rx.fast import (dense_soft, dense_sync, double_precision,
                                   phase_rot, real_columns, tone_vectors)
from opv_tpu_torch.rx.frame_decoder import decode_payloads
from opv_tpu_torch.rx.sync import normalized_sync, sync_pattern

_TWO_PI = 2.0 * math.pi
_SPS = CONFIG.samples_per_symbol
_SB = CONFIG.sync_bits
_EB = CONFIG.encoded_bits
_FS = CONFIG.frame_symbols
_SPF = _FS * _SPS

#: int8 window-row quantization step: int16 wire samples of amplitude
#: 16383 map to +-127 exactly (16383 / 129 = 127).  The soft stage rescales
#: its integer dot by INT8_SCALE/127, so downstream thresholds see
#: wire-scale values.
INT8_SCALE = 129.0

#: frame intervals the batch acquisition's timing refinement folds
REFINE_FOLD_CAP = 128

#: static bias of the smoothed 3-point parabola on the clean folded sync
#: correlation (calibrated from the air interface; same constant as the
#: JAX package's rx/locked.py)
_PB_BIAS = 0.0409839434


def _slice_rows(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """(C, N) -> (C, length), row c taken from starts[c].  A start past
    N - length clamps back into range (it does not pad), as the JAX
    package's dynamic_slice does."""
    n = x.shape[1]
    st = torch.clamp(starts.to(torch.int64), 0, max(n - length, 0))
    idx = st[:, None] + torch.arange(length, device=x.device)[None, :]
    return x.gather(1, idx)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 where none): argmax over uint8,
    since argmax rejects bool and both frameworks return the first max."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _masked_argmax(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    neg = torch.full_like(x, -math.inf)
    return torch.argmax(torch.where(keep, x, neg), dim=-1)


def acquire_grid(raw: torch.Tensor) -> torch.Tensor:
    """(C, M) dense sync correlation -> (C,) int32 first sync position:
    the earliest position of the first frame interval reaching 90% of the
    interval's maximum, refined to the raw peak within one symbol."""
    window = raw[:, :_SPF]
    wmax = window.amax(dim=-1, keepdim=True)
    first = _first_true(window >= 0.9 * wmax)[:, None]
    idx = torch.arange(window.shape[-1], device=raw.device)[None, :]
    near = (idx >= first) & (idx < first + _SPS)
    return _masked_argmax(window, near).to(torch.int32)


def hunt_grid(raw: torch.Tensor, norm: torch.Tensor, stride: int = 1):
    """Earliest verified sync over the whole dense range: hunt thresholds
    (norm >= 0.85 and raw >= 5000) AND the locked threshold one frame
    later.  Returns ((C,) p0, (C,) found, (C,) p0_unverified, (C,)
    found_unverified), p0 in sample units."""
    cand_u = (norm >= CONFIG.sync_hunt_norm_thresh) & \
             (raw >= CONFIG.sync_hunt_raw_thresh)
    recheck = norm >= CONFIG.sync_locked_norm_thresh
    m = raw.shape[-1]
    spf_u = _SPF // stride
    nxt = torch.cat([recheck[:, spf_u:],
                     torch.zeros_like(recheck[:, : min(spf_u, m)])], dim=1)
    cand = cand_u & nxt
    idx = torch.arange(m, device=raw.device)[None, :]
    sym_u, half_u = _SPS // stride, _SPS // (2 * stride)

    def first_peak(c):
        found = c.any(dim=-1)
        first = _first_true(c)[:, None]
        # refine to the raw peak within one symbol centred on the first
        # qualifying position (the normalized metric saturates on a plateau)
        near = (idx >= first - half_u) & (idx < first + sym_u - half_u)
        return (_masked_argmax(raw, near) * stride).to(torch.int32), found

    p0, found = first_peak(cand)
    p0_u, found_u = first_peak(cand_u)
    return p0, found, p0_u, found_u


def _window_rows_of(samples: torch.Tensor, nsym: int) -> torch.Tensor:
    """(C, M, 80) rows covering symbols 0..nsym from any accepted input
    form; a view (no copy) for complex64 and complex128, pairs and window
    rows."""
    c = samples.shape[0]
    if samples.dim() == 3 and samples.shape[-1] == 2 * _SPS:
        return samples
    if samples.dim() == 3:                                    # (C, N, 2)
        return samples[:, : (nsym + 1) * _SPS].reshape(c, nsym + 1, 2 * _SPS)
    win = samples[:, : (nsym + 1) * _SPS]
    if win.dtype != torch.complex128:
        win = win.to(torch.complex64)
    return torch.view_as_real(win).reshape(c, nsym + 1, 2 * _SPS)


def soft_stage_operands(samples: torch.Tensor, r: torch.Tensor,
                        freq_offset: torch.Tensor, nsym: int, scale=None,
                        frac=None):
    """The soft stage's operands (rows, kern, resc, phi) in the contract of
    ops/symbol_soft.py, built in plain torch: the per-channel tone vectors,
    the tail mask at phase r with the `frac` blend, and the int8 kernel
    round(k*127) with its rescale for int8 rows.  complex128 samples (or
    float64 pairs or rows) give float64 operands throughout, the tone
    vectors and phi taken from their float32 values, as the JAX package's
    real_dt/cplx_dt build them."""
    c = samples.shape[0]
    dev = samples.device
    real = torch.float64 if double_precision(samples) else torch.float32
    e, incs = tone_vectors(freq_offset)                        # (C, 40, 2)
    e = e.to(torch.complex128 if real == torch.float64 else torch.complex64)
    t_idx = torch.arange(_SPS, device=dev)[None, :]
    rr = r.to(torch.int64)[:, None]
    if frac is None:
        tail_w = (t_idx >= rr).to(real)
    else:
        f = frac.to(real)[:, None]
        tail_w = torch.where(t_idx > rr, torch.ones_like(f),
                             torch.where(t_idx == rr, 1.0 - f,
                                         torch.zeros_like(f)))
    tail_w = tail_w[:, :, None]
    kern = real_columns(torch.cat([tail_w * e, (1.0 - tail_w) * e], dim=-1))
    rows = _window_rows_of(samples, nsym)
    phi = torch.view_as_real(phase_rot(incs)).to(real).contiguous()  # (C, 2, 2)
    if rows.dtype == torch.int8:
        kern = torch.round(kern * 127.0).to(torch.int8)
        if scale is None:
            resc = torch.full((c,), np.float32(INT8_SCALE / 127.0), device=dev)
        else:
            resc = scale.to(device=dev, dtype=torch.float32) / 127.0
    else:
        if rows.dtype in (torch.bfloat16, torch.float16):
            # the JAX package narrows the columns to the rows' dtype and
            # sums in float32; the products of two narrowed values are
            # exact in float32, so widening both gives the same dot
            kern = kern.to(rows.dtype).to(torch.float32)
        rows = rows.to(real)
        resc = torch.ones((c,), dtype=real, device=dev)
    return rows, kern.contiguous(), resc.contiguous(), phi


def _symbol_soft_batch(samples: torch.Tensor, r: torch.Tensor,
                       freq_offset: torch.Tensor, nsym: int, scale=None,
                       frac=None) -> torch.Tensor:
    """Symbol-grid tone correlation at per-channel phase r -> (C, nsym).

    The phase-aligned window of symbol s spans the tail of static row s
    and the head of row s+1, so with A/B the tone correlations of each row
    masked at t >= r / t < r,

        corr(s) = e^{j inc r} (A(s) + e^{-40j inc} B(s+1)),

    and the leading phase drops inside |corr|^2.  `frac` (C,) in [0, 1)
    blends the mask kernels of r and r+1 (linear interpolation of the
    stream at r + frac): the tap t == r weighs 1-frac on the tail side and
    frac on the head side.  int8 rows use the int8 kernel round(k*127) and
    an exact integer dot, rescaled by INT8_SCALE/127 (or scale/127 per
    channel).  The correlation and the combine run in registry.symbol_soft
    (the fused CUDA kernel for CUDA tensors)."""
    ops = soft_stage_operands(samples, r, freq_offset, nsym, scale, frac)
    return registry.symbol_soft(*ops, nsym)


def _extract_frames(soft: torch.Tensor, k0: torch.Tensor, n_frames: int):
    """(C, nsym) soft stream -> (payloads (C, F, 2144), sync_q (C, F),
    sync_raw (C, F)).  The stream is zero-padded so a sync anywhere in the
    window still yields full frames; frames reaching into the padding read
    zeros and fail the sync-quality gate.  The two 24-tap sums are taken in
    float64 and rounded once, so a channel's sync quality does not depend
    on how many channels share the call (BLAS picks its matrix-vector path
    by shape)."""
    c, nsym = soft.shape
    span = n_frames * _FS
    padded = F.pad(soft, (0, span))
    w = _slice_rows(padded, torch.clamp(k0, 0, nsym), span)
    fr = w.reshape(c, n_frames, _FS)
    sync_w = fr[:, :, :_SB].to(torch.float64)
    pat = device_table(sync_pattern, soft.device, torch.float64)
    raw = (sync_w * pat).sum(-1).to(soft.dtype)
    q = normalized_sync(raw, sync_w.abs().sum(-1).to(soft.dtype))
    return fr[:, :, _SB:], q, raw


def _locked_body(samples, p0, freq_offset, n_frames: int, scale=None,
                 frac=None):
    c = samples.shape[0]
    windowed = samples.dim() == 3 and samples.shape[-1] == 2 * _SPS
    n = samples.shape[1] * _SPS if windowed else samples.shape[1]
    p0 = p0.to(torch.int32)
    r = p0 % _SPS
    k0 = (p0 - r) // _SPS
    nsym = (n - _SPS) // _SPS
    soft = _symbol_soft_batch(samples, r, freq_offset, nsym, scale, frac)
    payloads, q, raw = _extract_frames(soft, k0, n_frames)
    frames, metrics, ok = decode_payloads(payloads.reshape(-1, _EB))
    ok = ok.reshape(c, n_frames)
    # flywheel: a sub-threshold sync still emits its frame while any of the
    # preceding sync_miss_limit slots re-checked OK
    w = CONFIG.sync_miss_limit + 1
    qp = F.pad(q, (w - 1, 0), value=-math.inf)
    q_trail = torch.stack([qp[:, i:i + n_frames] for i in range(w)]).amax(0)
    fv = ok & (q_trail >= CONFIG.sync_locked_norm_thresh)
    return dict(
        frames=frames.reshape(c, n_frames, CONFIG.frame_bytes),
        metrics=metrics.reshape(c, n_frames),
        frame_valid=fv, sync_q=q, sync_raw=raw, decode_ok=ok, p0=p0,
        freq_offset=freq_offset,
        frac=(frac.to(torch.float32) if frac is not None
              else torch.zeros(c, dtype=torch.float32, device=p0.device)),
        n_decoded=fv.sum(),
    )


def rx_locked_steady(samples: torch.Tensor, p0: torch.Tensor,
                     freq_offset: torch.Tensor, n_frames: int, scale=None,
                     frac=None):
    """Steady-state hot loop with the grid (p0, frac) and CFO known: blocks
    that advance by whole frame intervals keep p0.  Returns the same dict
    as rx_locked."""
    return _locked_body(samples, p0, freq_offset, n_frames, scale, frac)


def rx_locked_reacquire(samples: torch.Tensor, p0_old: torch.Tensor,
                        freq_offset_old: torch.Tensor, keep: torch.Tensor,
                        n_frames: int, frac_old=None):
    """Selective re-acquisition: channels with keep=True retain their grid
    (p0, frac) and CFO; the others are hunted over the whole (C, N)
    complex64 block.

    The hunt runs at the carried CFO (zero for channels never locked): the
    40-sample tone correlation loses <2% even at the +-2 kHz AFC clamp.  An
    isolated single-frame burst (a hunt candidate with no second sync one
    frame later) is processed on its own grid and flagged in `burst_only`,
    so the streaming engine can emit its frame without taking the lock.
    CFO is estimated on one frame interval at the acquired p0 (the block
    may hold noise before a mid-block burst), then refined twice by the
    feed-forward discriminator; the newly acquired channels take their
    sub-sample timing from the hunt's own dense correlation, folded.
    Returns rx_locked's dict plus burst_only (C,) bool."""
    raw, p0, acquired, burst_only = _hunt(samples, p0_old, freq_offset_old,
                                          keep, 1)
    freq_offset = rx_locked_reacquire_cfo(samples, p0, freq_offset_old, keep)
    if frac_old is None:
        frac_old = torch.zeros(samples.shape[0], dtype=torch.float32,
                               device=samples.device)
    p0_r, frac_new = refine_timing_from_raw(raw, p0)
    p0 = torch.where(acquired, p0_r, p0)
    frac = torch.where(acquired, frac_new, frac_old.to(torch.float32))
    out = _locked_body(samples, p0, freq_offset, n_frames, frac=frac)
    out["burst_only"] = burst_only
    return out


def _hunt(samples, p0_old, freq_offset_old, keep, stride: int):
    """The re-acquisition's dense hunt at sample stride `stride` ->
    (raw (C, M), p0 (C,) int32 in samples, acquired (C,), burst_only (C,)):
    kept channels and channels where nothing qualifies keep p0_old; a
    verified candidate wins over an unverified one (a lone burst)."""
    hunt_foff = torch.where(keep, freq_offset_old,
                            torch.zeros_like(freq_offset_old))
    raw, norm = dense_sync(dense_soft(samples, hunt_foff, stride), stride)
    p0_new, found, p0_u, found_u = hunt_grid(raw, norm, stride)
    burst_only = ~keep & ~found & found_u
    p0 = torch.where(keep | ~(found | found_u), p0_old.to(torch.int32),
                     torch.where(found, p0_new, p0_u))
    return raw, p0, ~keep & (found | found_u), burst_only


def rx_locked_hunt_strided(samples: torch.Tensor, p0_old: torch.Tensor,
                           freq_offset_old: torch.Tensor, keep: torch.Tensor,
                           stride: int = 2):
    """The dense hunt of rx_locked_reacquire at sample stride `stride`
    (default 2: detection-safe on the 2-sample MSK sync apex plateau, half
    the dense pass).  Returns dict(p0 (C,) int32 in samples, acquired (C,)
    bool, burst_only (C,) bool); the sub-sample grid comes from a full-
    resolution refine afterwards (rx_locked_reacquire_strided)."""
    _, p0, acquired, burst_only = _hunt(samples, p0_old, freq_offset_old,
                                        keep, stride)
    return dict(p0=p0, acquired=acquired, burst_only=burst_only)


def rx_locked_reacquire_cfo(samples: torch.Tensor, p0: torch.Tensor,
                            freq_offset_old: torch.Tensor,
                            keep: torch.Tensor) -> torch.Tensor:
    """The re-acquisition's merged (C,) float32 CFO at the grid p0: the
    grid estimate on one frame interval at p0, refined twice by the
    feed-forward discriminator; kept channels carry freq_offset_old."""
    seg = _slice_rows(samples, p0, _SPF)
    cfo_new = estimate_cfo_batch(seg).to(torch.float32)
    # seg already starts at the acquired sync, so the refine slice is the
    # identity
    at_seg = torch.zeros_like(p0)
    cfo_new = refine_cfo_locked(seg, at_seg, cfo_new)
    cfo_new = refine_cfo_locked(seg, at_seg, cfo_new)
    return torch.where(keep, freq_offset_old, cfo_new)


def rx_locked_reacquire_strided(samples: torch.Tensor, p0_old: torch.Tensor,
                                freq_offset_old: torch.Tensor,
                                keep: torch.Tensor, n_frames: int,
                                frac_old: torch.Tensor, stride: int = 2):
    """rx_locked_reacquire with the hunt at sample stride `stride`: the
    strided hunt, the CFO at the hunt's grid, refine_timing_locked at that
    CFO (full resolution: a strided fold would halve the sub-sample
    estimate's resolution), then the steady body at the refined grid for
    the newly acquired channels (kept ones keep p0_old and frac_old).  The
    JAX package runs these four steps as four device programs; the result
    is the same dict as rx_locked_reacquire's, burst_only from the hunt."""
    h = rx_locked_hunt_strided(samples, p0_old, freq_offset_old, keep, stride)
    freq_offset = rx_locked_reacquire_cfo(samples, h["p0"], freq_offset_old,
                                          keep)
    p0_r, frac_r, _ = refine_timing_locked(samples, h["p0"], freq_offset,
                                           n_frames)
    acquired = h["acquired"]
    p0 = torch.where(acquired, p0_r, h["p0"])
    frac = torch.where(acquired, frac_r, frac_old.to(torch.float32))
    out = _locked_body(samples, p0, freq_offset, n_frames, frac=frac)
    out["burst_only"] = h["burst_only"]
    return out


def rx_locked(samples: torch.Tensor, n_frames: int, freq_offset=None,
              estimate_cfo_flag: bool = True):
    """(C, N) complex64 (or complex128, in float64) -> n_frames decoded
    frames per channel.

    N must cover p0 + n_frames full frames.  Returns dict with frames
    (C, F, 134) uint8, metrics (C, F) int32, frame_valid / decode_ok (C, F)
    bool, sync_q / sync_raw (C, F), p0 (C,) int32, freq_offset (C,) and
    frac (C,) float32, n_decoded."""
    c, n = samples.shape
    dev = samples.device
    refine = False
    if freq_offset is None:
        if estimate_cfo_flag:
            freq_offset = estimate_cfo_batch(samples).to(torch.float32)
            refine = True
        else:
            freq_offset = torch.zeros(c, dtype=torch.float32, device=dev)
    freq_offset = freq_offset.to(device=dev, dtype=torch.float32)
    # acquisition on the first two frame intervals: the hunt's verified
    # earliest candidate needs one more frame for its re-check
    acq_len = min(n, (2 * _FS + _SB + 2) * _SPS)

    def acquire(foff):
        raw, norm = dense_sync(dense_soft(samples[:, :acq_len], foff))
        p0_hunt, found, _, _ = hunt_grid(raw, norm)
        return torch.where(found, p0_hunt, acquire_grid(raw)), found

    p0, found = acquire(freq_offset)
    if refine:
        # correct the grid estimator's bias with the feed-forward AFC
        # discriminator (twice), then re-hunt at the corrected offset
        freq_offset = refine_cfo_locked(samples, p0, freq_offset)
        freq_offset = refine_cfo_locked(samples, p0, freq_offset)
        p0, found = acquire(freq_offset)
        freq_offset = refine_cfo_locked(samples, p0, freq_offset)
    # sub-sample timing from one dense pass folded over up to 128 frames;
    # where the 2-frame hunt verified nothing, the folded argmax also
    # supplies the grid phase
    refine_len = min(n, (min(n_frames, REFINE_FOLD_CAP) + 1) * _SPF
                     + (_SB + 2) * _SPS)
    raw_r, _ = dense_sync(dense_soft(samples[:, :refine_len], freq_offset))
    fcount = raw_r.shape[1] // _SPF
    if fcount >= 2:
        fold = raw_r[:, : fcount * _SPF].reshape(c, fcount, _SPF).sum(1)
        p0 = torch.where(found, p0, torch.argmax(fold, -1).to(torch.int32))
    p0, frac = refine_timing_from_raw(raw_r, p0)
    return _locked_body(samples, p0, freq_offset, n_frames, frac=frac)


def refine_cfo_locked(samples: torch.Tensor, p0: torch.Tensor,
                      freq_offset: torch.Tensor) -> torch.Tensor:
    """Feed-forward CFO refinement at the locked grid -> (C,) float32 Hz.

    The AFC discriminator, batched: one frame of per-symbol tone
    correlations from the sync; consecutive symbols where the same tone
    dominates advance in phase by 2*pi*df*40/fs, so the power-weighted mean
    of the pairwise increments reads the residual offset df directly.  The
    correction is clamped to the reference's AFC authority (+-2 kHz).

    On the card (rx/cfo.py::needs_wide_sums) the correlations and sums run
    in float64, complex64 samples and tone tables widened exactly, and the
    offset is rounded to float32 once, so a channel's result does not
    depend on how many channels share the call."""
    seg = _slice_rows(samples, p0, _SPF)
    if needs_wide_sums(seg):
        seg = seg.to(torch.complex128)
    c = seg.shape[0]
    e, incs = tone_vectors(freq_offset)
    corr = torch.einsum("cst,ctk->csk", seg.reshape(c, _FS, _SPS),
                        e.to(seg.dtype))                          # (C, S, 2)
    p = corr.abs() ** 2
    dom = p[..., 1] > p[..., 0]
    sel = torch.where(dom, corr[..., 1], corr[..., 0])
    same = (dom[:, 1:] == dom[:, :-1]).to(p.dtype)
    adv = phase_rot(incs)
    # the per-symbol kernel restarts at phase 0 each symbol, so rotate out
    # the dominant tone's own per-symbol advance
    adv_dom = torch.where(dom[:, 1:], adv[:, 1:2], adv[:, 0:1])
    pair = sel[:, 1:] * torch.conj(sel[:, :-1]) * adv_dom
    pm = p.amax(-1)
    w = same * torch.minimum(pm[:, 1:], pm[:, :-1])
    ang = torch.atan2((pair.imag * w).sum(-1), (pair.real * w).sum(-1))
    k = CONFIG.sample_rate / (_TWO_PI * _SPS)
    df = ang * (np.float32(k) if ang.dtype == torch.float32 else k)
    df = torch.clamp(df, -CONFIG.afc_clamp_hz, CONFIG.afc_clamp_hz)
    return (freq_offset + df).to(torch.float32)


def _fold_est(fold: torch.Tensor) -> torch.Tensor:
    """(C, n_off+2) folded sync correlation -> (C,) float32 offset of the
    apex centre relative to fold[:, 0]: [1, 1] smoothing (the MSK apex is a
    2-sample plateau), first argmax over [0, n_off-1], 3-point parabola
    minus its calibrated bias; at pk == 0 the smoothed bin's own centre."""
    n_off = fold.shape[-1] - 2
    sm = fold[:, :-1] + fold[:, 1:]
    pk = torch.argmax(sm[:, :n_off], dim=-1)
    r0 = sm.gather(1, pk[:, None])[:, 0]
    rm = torch.where(pk > 0, sm.gather(1, (pk - 1).clamp(min=0)[:, None])[:, 0],
                     torch.zeros_like(r0))
    rp = sm.gather(1, (pk + 1)[:, None])[:, 0]
    denom = rm - 2.0 * r0 + rp
    ok = denom.abs() > 1e-30
    safe = torch.where(ok, denom, torch.ones_like(denom))
    delta = torch.where(ok, 0.5 * (rm - rp) / safe, torch.zeros_like(denom))
    bias = np.float32(_PB_BIAS) if delta.dtype == torch.float32 else _PB_BIAS
    delta = torch.where(pk == 0, torch.zeros_like(delta),
                        torch.clamp(delta, -0.5, 0.5) - bias)
    return pk.to(torch.float32) + delta + 0.5


def fold_est_np(fold: np.ndarray) -> np.ndarray:
    """Numpy twin of _fold_est for host-side use on accumulated folds."""
    fold = np.asarray(fold, np.float64)
    n_off = fold.shape[-1] - 2
    sm = fold[:, :-1] + fold[:, 1:]
    pk = np.argmax(sm[:, :n_off], axis=-1).astype(np.int64)
    rows = np.arange(fold.shape[0])
    r0 = sm[rows, pk]
    rm = np.where(pk > 0, sm[rows, np.maximum(pk - 1, 0)], 0.0)
    rp = sm[rows, pk + 1]
    denom = rm - 2.0 * r0 + rp
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(np.abs(denom) > 1e-30, 0.5 * (rm - rp) / denom, 0.0)
    delta = np.where(pk == 0, 0.0, np.clip(delta, -0.5, 0.5) - _PB_BIAS)
    return (pk + delta + 0.5).astype(np.float32)


def refine_timing_from_raw(raw: torch.Tensor, p0: torch.Tensor):
    """Sub-sample timing from a dense sync correlation (C, M): fold every
    complete frame interval, take the +-20-sample segment around p0 and
    refine its apex.  Returns ((C,) int32 p0 >= 0, (C,) float32 frac)."""
    c, m = raw.shape
    f = m // _SPF
    half = _SPS // 2
    n_off = 2 * half + 1
    if f < 1:
        return p0, torch.full((c,), 0.5, dtype=torch.float32, device=raw.device)
    fold = raw[:, : f * _SPF].reshape(c, f, _SPF).sum(1)
    fold2 = torch.cat([fold, fold[:, : n_off + 2]], dim=1)
    seg = _slice_rows(fold2, (p0.to(torch.int64) - half) % _SPF, n_off + 2)
    pos = torch.clamp(p0.to(torch.float32) + (_fold_est(seg) - half), min=0.0)
    fl = torch.floor(pos)
    return fl.to(torch.int32), (pos - fl).to(torch.float32)


def refine_timing_locked(samples: torch.Tensor, p0: torch.Tensor,
                         freq_offset: torch.Tensor, n_frames: int):
    """Sub-sample timing at a locked grid, folded over n_frames intervals.

    One slab per frame interval, starting 20 samples before p0 + k*86,720
    (clamped at 0), is correlated densely; the +-20-sample offsets of every
    slab are summed and the apex refined (_fold_est).  A slab that would
    run past the block's end is zeroed, not clamp-shifted, so it adds
    nothing misaligned.  Returns ((C,) int32 p0, (C,) float32 frac, (C, 43)
    fold), with the sync at p0 + frac and fold bin b at sample offset
    max(p0 - 20, 0) + b of each frame interval.  Where even slab 0 runs
    past the end, the fold is all zero: the input p0 is kept with frac 0.5
    (the centre of the 2-sample apex plateau)."""
    c, n_total = samples.shape
    half = _SPS // 2
    n_off = 2 * half + 1
    # slab: the offsets, the sync correlation's 24-symbol reach, one
    # symbol and an interpolation margin
    slab_len = n_off + (_SB - 1) * _SPS + _SPS + 8
    base = torch.clamp(p0.to(torch.int32) - half, min=0)
    zero = torch.zeros((), dtype=samples.dtype, device=samples.device)
    slabs = []
    for k in range(n_frames):
        st = base + k * _SPF
        ok = (st + slab_len <= n_total)[:, None]
        slabs.append(torch.where(ok, _slice_rows(samples, st, slab_len), zero))
    # zero padding past the correlators' valid trim (39-sample tone window
    # and 920-sample dilated sync reach) so raw covers every slab offset
    slabs.append(torch.zeros((c, 1024), dtype=samples.dtype,
                             device=samples.device))
    raw, _ = dense_sync(dense_soft(torch.cat(slabs, dim=1), freq_offset))
    raw = raw[:, : n_frames * slab_len].reshape(c, n_frames, slab_len)
    fold = raw[:, :, : n_off + 2].sum(1)
    pos = base.to(torch.float32) + _fold_est(fold)
    fl = torch.floor(pos)
    valid0 = base + slab_len <= n_total
    p0r = torch.where(valid0, fl.to(torch.int32), p0.to(torch.int32))
    frac = torch.where(valid0, pos - fl, torch.full_like(pos, 0.5))
    return p0r, frac.to(torch.float32), fold


def rx_locked_retime(samples: torch.Tensor, p0: torch.Tensor,
                     freq_offset: torch.Tensor, n_frames: int = 1):
    """Timing refresh of locked channels: refine_timing_locked anchored one
    frame after p0 (so a backward drift across the block start stays in
    view).  Returns ((C,) int32 delta clipped to +-20, (C,) float32 frac,
    (C, 43) fold): the corrected grid is p0 + delta with frac, and fold bin
    b sits at offset p0 - 20 + b, for accumulation across blocks."""
    p0 = p0.to(torch.int32)
    p0r, frac, fold = refine_timing_locked(samples, p0 + _SPF, freq_offset,
                                           n_frames)
    half = _SPS // 2
    delta = torch.clamp(p0r - _SPF - p0, -half, half).to(torch.int32)
    return delta, frac, fold


def state_from_numpy(d, device=None) -> dict:
    """Receiver state from a numpy mapping (e.g. the JAX package's rx_locked
    output): p0 -> int32, freq_offset / frac / scale -> float32 tensors on
    `device`.  frac and scale are None when absent."""
    def get(k, dt):
        v = d.get(k)
        if v is None:
            return None
        return torch.as_tensor(np.array(v), dtype=dt, device=device)

    return dict(p0=get("p0", torch.int32),
                freq_offset=get("freq_offset", torch.float32),
                frac=get("frac", torch.float32),
                scale=get("scale", torch.float32))


def to_window_rows(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(C, N) complex -> (C, N//40, 80) window rows (the steady body's
    buffer form): float rows keep the values; int8 rows hold
    clip(round(value / INT8_SCALE), -127, 127), half to even."""
    c, n = x.shape
    pairs = torch.view_as_real(x[:, : (n // _SPS) * _SPS])
    rows = pairs.reshape(c, n // _SPS, 2 * _SPS)
    if dtype == torch.int8:
        return torch.clamp(torch.round(rows / INT8_SCALE), -127, 127
                           ).to(torch.int8)
    return rows.to(dtype).contiguous()
