"""The AFC/TED symbol-tracking loop: the hand-written CUDA kernel
(csrc/track_symbols.cu) and its plain twin, one contract in two
precisions (R = float64 or float32):

    samples (C, CAP) complex128 / complex64, n_valid (C,) int32,
    state (C, 9) R, afc_alpha, maxs ->
        soft (C, maxs) R, sym_valid (C, maxs) bool,
        state (C, 9) R, samples_used (C,) int32

The state row is the loop carry of opv_tpu/rx/demod.py::LoopState packed
as [mu, phase_f1, phase_f2, freq_offset, timing_freq, prev_c1.real,
prev_c1.imag, prev_c2.real, prev_c2.imag].  Per channel, symbol k is the
k-th step of demodulate_block's scan: interpolate the on-time, early and
late samples at 40 taps, correlate them against both tones' LOs, take
soft = |c2|^2 - |c1|^2, then the early-late TED, the 2nd-order timing loop,
the AFC from the dominant tone's inter-symbol phase (not on a call's first
symbol) and the split advance of pos/mu.  A step is active while
pos < n_valid - 50; the active steps come first, and the rest are zeros.

Replaces the lax.scan of opv_tpu/rx/demod.py::demodulate_block (`:195`),
not a Pallas kernel.  The twin runs the per-tap vector work as torch ops
over all channels at once and the scalar loop update over Python floats
(IEEE doubles, no fused multiply-adds, as the kernel's __dmul_rn /
__dadd_rn) or, in float32, over numpy float32 scalars, each operation
rounded to float32 as JAX's float32 scan rounds it (the constants too:
2 pi, pi, 40, 1e-10, the gains and clamps), one symbol per Python step.
The kernel counts its launches per precision.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.ops import build

_SPS = CONFIG.samples_per_symbol      # 40 taps per symbol
_EL = CONFIG.el_offset                # 10.0, the early/late spacing
_WIN = 64                             # the interpolation window
_GATE = _SPS + int(_EL)               # active while pos < n_valid - 50
_PI = math.pi
_TWO_PI = 2.0 * math.pi
STATE_WIDTH = 9


def params(afc_alpha: float) -> tuple:
    """The loop's constants in the kernel's order."""
    return (CONFIG.freq_dev, CONFIG.sample_rate, CONFIG.symbol_rate,
            CONFIG.alpha_timing, CONFIG.beta_timing,
            CONFIG.timing_freq_clamp, CONFIG.timing_adj_clamp,
            CONFIG.afc_clamp_hz, float(afc_alpha))


#: complex sample dtype -> the loop's real dtype
REAL = {torch.complex128: torch.float64, torch.complex64: torch.float32}


def _clip(x, lo, hi):
    """jnp.clip's order: maximum with lo, then minimum with hi."""
    x = lo if x < lo else x
    return hi if x > hi else x


def _wrap(p, pi, two_pi):
    if p > pi:
        p = p - two_pi
    if p < -pi:
        p = p + two_pi
    return p


def _check(samples, n_valid, state, maxs: int) -> torch.dtype:
    """The loop's real dtype, after checking the shapes and dtypes."""
    c = samples.shape[0]
    if samples.dtype not in REAL or samples.dim() != 2 \
            or samples.shape[1] < _WIN:
        raise ValueError(f"samples must be (C, CAP >= {_WIN}) complex128 or "
                         f"complex64, got {tuple(samples.shape)} "
                         f"{samples.dtype}")
    rdt = REAL[samples.dtype]
    if state.dtype != rdt or state.shape != (c, STATE_WIDTH):
        raise ValueError(f"state must be ({c}, {STATE_WIDTH}) {rdt}, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if n_valid.shape != (c,):
        raise ValueError(f"n_valid must be ({c},), got {tuple(n_valid.shape)}")
    if maxs < 0:
        raise ValueError(f"maxs must be >= 0, got {maxs}")
    return rdt


def track_symbols_reference(samples: torch.Tensor, n_valid: torch.Tensor,
                            state: torch.Tensor, afc_alpha: float, maxs: int):
    """The plain twin (CPU): one Python step per symbol, the per-tap work
    as torch ops over every channel, the scalar update over Python floats
    (float64) or numpy float32 scalars (float32)."""
    rdt = _check(samples, n_valid, state, maxs)
    f32 = rdt == torch.float32
    R = np.float32 if f32 else float
    atan2 = np.arctan2 if f32 else math.atan2
    fd, fs, sr, alpha_t, beta_t, tf_clamp, adj_clamp, afc_clamp, aa = \
        (R(v) for v in params(afc_alpha))
    pi, two_pi, eps, sps = R(_PI), R(_TWO_PI), R(1e-10), R(_SPS)
    c, cap = samples.shape
    dev = samples.device
    flat = samples.reshape(-1)
    first = samples[:, 0].tolist()
    rt = dict(dtype=rdt, device=dev)
    i40 = torch.arange(_SPS, **rt)
    # on-time, early, late: rel_on, rel_on - 10, rel_on + 10
    el3 = torch.tensor([[0.0], [-_EL], [_EL]], **rt)
    lim = [n - _GATE for n in n_valid.tolist()]
    st = [[R(v) for v in row] for row in state.tolist()]
    mu = [r[0] for r in st]
    ph1 = [r[1] for r in st]
    ph2 = [r[2] for r in st]
    foff = [r[3] for r in st]
    tfreq = [r[4] for r in st]
    pc1 = [(r[5], r[6]) for r in st]
    pc2 = [(r[7], r[8]) for r in st]
    pos = [0] * c
    soft = [[] for _ in range(c)]
    for k in range(maxs):
        active = [ch for ch in range(c) if pos[ch] < lim[ch]]
        if not active:
            break
        rows, bases = [], []
        for ch in range(c):
            base = min(max(pos[ch] - 11, 0), cap - _WIN)
            inc1 = two_pi * (-fd + foff[ch]) / fs
            inc2 = two_pi * (fd + foff[ch]) / fs
            rows.append((R(pos[ch] - base) + mu[ch], ph1[ch], ph2[ch],
                         inc1, inc2))
            bases.append(base + ch * cap)
        p = torch.tensor(rows, **rt)
        rel = (p[:, :1] + i40)[:, None, :] + el3            # (C, 3, 40)
        rel = rel.clamp_(0.0, _WIN - 1.0)
        i0 = rel.floor().clamp_(max=_WIN - 2.0)
        f = rel - i0
        idx = i0.long() + torch.tensor(bases, device=dev)[:, None, None]
        s = flat.take(idx) * (1.0 - f) + flat.take(idx + 1) * f
        if k == 0:
            # the early sample is samples[0] where pos + i < 10
            for ch in range(c):
                if pos[ch] < int(_EL):
                    s[ch, 1, :int(_EL) - pos[ch]] = first[ch]
        arg = p[:, 1:3, None] + i40 * p[:, 3:5, None]       # (C, 2, 40)
        lo = torch.complex(torch.cos(arg), -torch.sin(arg))
        corr = torch.matmul(s, lo.transpose(1, 2)).tolist()  # (C, 3, 2)
        for ch in active:
            (c1r, c1i), (c2r, c2i), (c1er, c1ei), (c2er, c2ei), \
                (c1lr, c1li), (c2lr, c2li) = (
                    (R(z.real), R(z.imag)) for pair in corr[ch] for z in pair)
            inc1, inc2 = rows[ch][3:5]
            e1 = c1r * c1r + c1i * c1i
            e2 = c2r * c2r + c2i * c2i
            soft[ch].append(e2 - e1)
            f1_dom = e1 > e2
            ze, zl = (((c1er, c1ei), (c1lr, c1li)) if f1_dom
                      else ((c2er, c2ei), (c2lr, c2li)))
            ee = ze[0] * ze[0] + ze[1] * ze[1]
            el = zl[0] * zl[0] + zl[1] * zl[1]
            ted = (el - ee) / ((el + ee) + eps)
            tf_n = _clip(tfreq[ch] + beta_t * ted, -tf_clamp, tf_clamp)
            adj = _clip(alpha_t * ted + tf_n, -adj_clamp, adj_clamp)
            # dom * conj(prev dom), as the complex product rounds it
            (dr, di), (pr, pim) = (((c1r, c1i), pc1[ch]) if f1_dom
                                   else ((c2r, c2i), pc2[ch]))
            zr = dr * pr - di * -pim
            zi = dr * -pim + di * pr
            ferr = atan2(zi, zr) * sr / two_pi
            if k >= 1:
                foff[ch] = _clip(foff[ch] + aa * ferr, -afc_clamp, afc_clamp)
            ph1[ch] = _wrap(ph1[ch] + sps * inc1, pi, two_pi)
            ph2[ch] = _wrap(ph2[ch] + sps * inc2, pi, two_pi)
            t = mu[ch] + (sps + adj)
            t_int = math.floor(t)
            pos[ch] += t_int
            mu[ch] = t - R(t_int)
            tfreq[ch] = tf_n
            pc1[ch], pc2[ch] = (c1r, c1i), (c2r, c2i)
    nsym = torch.tensor([len(r) for r in soft], dtype=torch.int64, device=dev)
    out = torch.zeros((c, maxs), **rt)
    for ch in range(c):
        if soft[ch]:
            out[ch, :len(soft[ch])] = torch.tensor([float(v) for v in soft[ch]],
                                                   **rt)
    sym_valid = torch.arange(maxs, device=dev)[None, :] < nsym[:, None]
    new_state = torch.tensor(
        [[float(v) for v in (mu[ch], ph1[ch], ph2[ch], foff[ch], tfreq[ch],
                             *pc1[ch], *pc2[ch])] for ch in range(c)],
        **rt).reshape(c, STATE_WIDTH)
    used = torch.tensor(pos, dtype=torch.int32, device=dev)
    return out, sym_valid, new_state, used


def launch(lib, samples: torch.Tensor, n_valid: torch.Tensor,
           state: torch.Tensor, afc_alpha: float, maxs: int):
    """One launch of `lib`'s opv_track_symbols (complex128) or
    opv_track_symbols_f32 (complex64) on samples' stream (checked CUDA
    tensors; no count; nothing to launch for no channels).  `lib` is the
    port's library or another build exporting the same C entry points.
    A complex64 row of odd length, or storage off 16 bytes, is copied into
    rows at an even pitch first: the kernel's bulk copies move whole 16
    bytes."""
    c, cap = samples.shape
    dev = samples.device
    rdt = REAL[samples.dtype]
    samples = samples.contiguous()
    ld = cap
    if rdt == torch.float32 and (cap % 2 or samples.data_ptr() % 16):
        ld = cap + cap % 2
        padded = samples.new_zeros((c, ld))
        padded[:, :cap] = samples
        samples = padded
    n_valid = n_valid.to(device=dev, dtype=torch.int32).contiguous()
    state = state.to(dev).contiguous()
    soft = torch.empty((c, maxs), dtype=rdt, device=dev)
    sym_valid = torch.empty((c, maxs), dtype=torch.bool, device=dev)
    new_state = torch.empty((c, STATE_WIDTH), dtype=rdt, device=dev)
    used = torch.empty((c,), dtype=torch.int32, device=dev)
    if c:
        prm = (ctypes.c_double * 9)(*params(afc_alpha))
        ptrs = (n_valid.data_ptr(), state.data_ptr(), c, maxs, prm,
                soft.data_ptr(), sym_valid.data_ptr(), new_state.data_ptr(),
                used.data_ptr(), build.stream_ptr(samples))
        if rdt == torch.float32:
            err = lib.opv_track_symbols_f32(samples.data_ptr(), cap, ld, *ptrs)
        else:
            err = lib.opv_track_symbols(samples.data_ptr(), cap, *ptrs)
        build.check(build.library(), err, "track_symbols")
    return soft, sym_valid, new_state, used


def track_symbols_cuda(samples: torch.Tensor, n_valid: torch.Tensor,
                       state: torch.Tensor, afc_alpha: float, maxs: int):
    """The kernel: a block of three warps per channel, on samples' stream."""
    if not samples.is_cuda:
        raise ValueError("the CUDA track_symbols kernel needs a CUDA tensor")
    rdt = _check(samples, n_valid, state, maxs)
    out = launch(build.library(), samples, n_valid, state, afc_alpha, maxs)
    if samples.shape[0]:
        track_symbols_cuda.launches[
            "float32" if rdt == torch.float32 else "float64"] += 1
    return out


#: launches per precision (one kernel template, two instantiations)
track_symbols_cuda.launches = {"float64": 0, "float32": 0}
