"""The AFC/TED symbol-tracking loop: the hand-written CUDA kernel
(csrc/track_symbols.cu) and its plain twin, one contract:

    samples (C, CAP) complex128, n_valid (C,) int32, state (C, 9) float64,
    afc_alpha, maxs ->
        soft (C, maxs) float64, sym_valid (C, maxs) bool,
        state (C, 9) float64, samples_used (C,) int32

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
__dadd_rn), one symbol per Python step.
"""

from __future__ import annotations

import ctypes
import math

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


def _clip(x: float, lo: float, hi: float) -> float:
    """jnp.clip's order: maximum with lo, then minimum with hi."""
    x = lo if x < lo else x
    return hi if x > hi else x


def _wrap(p: float) -> float:
    if p > _PI:
        p -= _TWO_PI
    if p < -_PI:
        p += _TWO_PI
    return p


def _check(samples, n_valid, state, maxs: int):
    c = samples.shape[0]
    if samples.dtype != torch.complex128 or samples.dim() != 2 \
            or samples.shape[1] < _WIN:
        raise ValueError(f"samples must be (C, CAP >= {_WIN}) complex128, got "
                         f"{tuple(samples.shape)} {samples.dtype}")
    if state.dtype != torch.float64 or state.shape != (c, STATE_WIDTH):
        raise ValueError(f"state must be ({c}, {STATE_WIDTH}) float64, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if n_valid.shape != (c,):
        raise ValueError(f"n_valid must be ({c},), got {tuple(n_valid.shape)}")
    if maxs < 0:
        raise ValueError(f"maxs must be >= 0, got {maxs}")


def track_symbols_reference(samples: torch.Tensor, n_valid: torch.Tensor,
                            state: torch.Tensor, afc_alpha: float, maxs: int):
    """The plain twin (CPU): one Python step per symbol, the per-tap work
    as torch ops over every channel, the scalar update over floats."""
    _check(samples, n_valid, state, maxs)
    fd, fs, sr, alpha_t, beta_t, tf_clamp, adj_clamp, afc_clamp, aa = \
        params(afc_alpha)
    c, cap = samples.shape
    dev = samples.device
    flat = samples.reshape(-1)
    first = samples[:, 0].tolist()
    f64 = dict(dtype=torch.float64, device=dev)
    i40 = torch.arange(_SPS, **f64)
    # on-time, early, late: rel_on, rel_on - 10, rel_on + 10
    el3 = torch.tensor([[0.0], [-_EL], [_EL]], **f64)
    lim = [n - _GATE for n in n_valid.tolist()]
    st = state.tolist()
    mu = [r[0] for r in st]
    ph1 = [r[1] for r in st]
    ph2 = [r[2] for r in st]
    foff = [r[3] for r in st]
    tfreq = [r[4] for r in st]
    pc1 = [complex(r[5], r[6]) for r in st]
    pc2 = [complex(r[7], r[8]) for r in st]
    pos = [0] * c
    soft = [[] for _ in range(c)]
    for k in range(maxs):
        active = [ch for ch in range(c) if pos[ch] < lim[ch]]
        if not active:
            break
        rows = []
        for ch in range(c):
            base = min(max(pos[ch] - 11, 0), cap - _WIN)
            inc1 = _TWO_PI * (-fd + foff[ch]) / fs
            inc2 = _TWO_PI * (fd + foff[ch]) / fs
            rows.append((float(pos[ch] - base) + mu[ch], ph1[ch], ph2[ch],
                         inc1, inc2, float(base + ch * cap)))
        p = torch.tensor(rows, **f64)
        rel = (p[:, :1] + i40)[:, None, :] + el3            # (C, 3, 40)
        rel = rel.clamp_(0.0, _WIN - 1.0)
        i0 = rel.floor().clamp_(max=_WIN - 2.0)
        f = rel - i0
        idx = (i0 + p[:, 5, None, None]).long()
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
            (c1, c2), (c1e, c2e), (c1l, c2l) = corr[ch]
            inc1, inc2 = rows[ch][3:5]
            e1 = c1.real * c1.real + c1.imag * c1.imag
            e2 = c2.real * c2.real + c2.imag * c2.imag
            soft[ch].append(e2 - e1)
            f1_dom = e1 > e2
            ze, zl = (c1e, c1l) if f1_dom else (c2e, c2l)
            ee = ze.real * ze.real + ze.imag * ze.imag
            el = zl.real * zl.real + zl.imag * zl.imag
            ted = (el - ee) / (el + ee + 1e-10)
            tf_n = _clip(tfreq[ch] + beta_t * ted, -tf_clamp, tf_clamp)
            adj = _clip(alpha_t * ted + tf_n, -adj_clamp, adj_clamp)
            z = (c1 * pc1[ch].conjugate()) if f1_dom \
                else (c2 * pc2[ch].conjugate())
            ferr = math.atan2(z.imag, z.real) * sr / _TWO_PI
            if k >= 1:
                foff[ch] = _clip(foff[ch] + aa * ferr, -afc_clamp, afc_clamp)
            ph1[ch] = _wrap(ph1[ch] + _SPS * inc1)
            ph2[ch] = _wrap(ph2[ch] + _SPS * inc2)
            t = mu[ch] + (_SPS + adj)
            t_int = math.floor(t)
            pos[ch] += t_int
            mu[ch] = t - t_int
            tfreq[ch] = tf_n
            pc1[ch], pc2[ch] = c1, c2
    nsym = torch.tensor([len(r) for r in soft], dtype=torch.int64, device=dev)
    out = torch.zeros((c, maxs), **f64)
    for ch in range(c):
        if soft[ch]:
            out[ch, :len(soft[ch])] = torch.tensor(soft[ch], **f64)
    sym_valid = torch.arange(maxs, device=dev)[None, :] < nsym[:, None]
    new_state = torch.tensor(
        [[mu[ch], ph1[ch], ph2[ch], foff[ch], tfreq[ch], pc1[ch].real,
          pc1[ch].imag, pc2[ch].real, pc2[ch].imag] for ch in range(c)],
        **f64).reshape(c, STATE_WIDTH)
    used = torch.tensor(pos, dtype=torch.int32, device=dev)
    return out, sym_valid, new_state, used


def launch(lib, samples: torch.Tensor, n_valid: torch.Tensor,
           state: torch.Tensor, afc_alpha: float, maxs: int):
    """One launch of `lib`'s opv_track_symbols on samples' stream (checked
    CUDA tensors; no count; nothing to launch for no channels).  `lib` is
    the port's library or another build exporting the same C entry point."""
    c, cap = samples.shape
    dev = samples.device
    samples = samples.contiguous()
    n_valid = n_valid.to(device=dev, dtype=torch.int32).contiguous()
    state = state.to(dev).contiguous()
    soft = torch.empty((c, maxs), dtype=torch.float64, device=dev)
    sym_valid = torch.empty((c, maxs), dtype=torch.bool, device=dev)
    new_state = torch.empty((c, STATE_WIDTH), dtype=torch.float64, device=dev)
    used = torch.empty((c,), dtype=torch.int32, device=dev)
    if c:
        prm = (ctypes.c_double * 9)(*params(afc_alpha))
        err = lib.opv_track_symbols(
            samples.data_ptr(), cap, n_valid.data_ptr(), state.data_ptr(), c,
            maxs, prm, soft.data_ptr(), sym_valid.data_ptr(),
            new_state.data_ptr(), used.data_ptr(), build.stream_ptr(samples))
        build.check(build.library(), err, "track_symbols")
    return soft, sym_valid, new_state, used


def track_symbols_cuda(samples: torch.Tensor, n_valid: torch.Tensor,
                       state: torch.Tensor, afc_alpha: float, maxs: int):
    """The kernel: a block of three warps per channel, on samples' stream."""
    if not samples.is_cuda:
        raise ValueError("the CUDA track_symbols kernel needs a CUDA tensor")
    _check(samples, n_valid, state, maxs)
    out = launch(build.library(), samples, n_valid, state, afc_alpha, maxs)
    if samples.shape[0]:
        track_symbols_cuda.launches += 1
    return out


track_symbols_cuda.launches = 0
