"""Analysis channelizer: one wideband capture -> K-channel bank
(counterpart of opv_tpu/rx/channelizer.py).

Channel c is decimate_K(lowpass_h(x[n] e^{-j2pi c n/K})).  Split the
stride-K modulated filterbank into its polyphase legs (t = pK + q):

    y_c[m] = sum_r W[c,r] * u[m,r],     u[m,r] = sum_p g[p,r] X[m+p, r]

with X[j, r] = x[jK + r] a free reshape of the stream, g the doubly
reversed prototype taps (polyphase_legs: taps_per_branch shifted,
column-weighted adds) and W the DFT across legs (dft_kernel: one
(M, 2K) x (2K, 2K) real matmul, complex through interleaved re/im rows).
Output channel c carries the band centred at +c * fs_ch (c > K/2 wraps to
negative frequencies) with a constant group delay of (K*taps_per_branch -
1)/K output samples and a constant per-channel phase, which the
non-coherent OPV demodulator ignores.

Plain torch on the input's device and dtype (float32 legs for complex64);
the JAX package computes the same outside any Pallas kernel.  The DFT
product accumulates in float64 and rounds once to the input's precision,
so the card and the host give the same channels (channelize_cols).

msk_wideband, wideband_test_channels and synthesize_wideband are the
simulation helpers of the channelizer tests and of chip_smoke.py, built on
the port's codec core and TX; each runs on its device= ("cuda" by
default).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG


@functools.lru_cache(maxsize=None)
def prototype_filter(k: int, taps_per_branch: int = 12,
                     beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed-sinc lowpass, cutoff at half the channel spacing:
    length K * taps_per_branch, unit passband gain, float64.  OPV occupies
    only the inner few percent of a 2.168 MHz channel, so the passband is
    flat where it matters; `beta` sets the adjacent-channel rejection."""
    n = k * taps_per_branch
    t = np.arange(n) - (n - 1) / 2
    h = np.sinc(t / k) * np.kaiser(n, beta)
    return (h / h.sum()).astype(np.float64)


@functools.lru_cache(maxsize=None)
def dft_kernel(k: int) -> np.ndarray:
    """The DFT-across-legs matmul kernel grouped by output channel: (2K,
    K, 2) float64, [:, c, 0] / [:, c, 1] the real / imaginary kernel
    columns of channel c.  Row 2r (the re leg of u_r) contributes wr to
    re_c and wi to im_c; row 2r+1 (the im leg) -wi and wr, with W[c, r] =
    e^{+2j pi c (K-1-r) / K}."""
    w = np.exp(2j * np.pi * np.arange(k)[:, None]
               * (k - 1 - np.arange(k))[None, :] / k)   # (c, r)
    wr, wi = w.real.T, w.imag.T                          # (r, c)
    kern = np.stack([np.stack([wr, wi], axis=-1),        # (r, c, 2)
                     np.stack([-wi, wr], axis=-1)],
                    axis=1)                               # (r, 2, c, 2)
    return kern.reshape(2 * k, k, 2)


@functools.lru_cache(maxsize=None)
def _on_device(name: str, k: int, taps: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """The tap matrix g (taps, K) or the DFT kernel (2K, K, 2) on `device`,
    copied there once: a copy from pageable host memory to the card
    synchronizes the stream.  Callers only read it."""
    if name == "taps":
        h = prototype_filter(k, taps)
        table = h.reshape(taps, k)[::-1, ::-1]   # g[p, r] = h[(taps-1-p)K + K-1-r]
    else:
        table = dft_kernel(k)
    return torch.from_numpy(np.ascontiguousarray(table)).to(device, dtype)


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.complex128 else torch.float32


def polyphase_legs(x: torch.Tensor, k: int,
                   taps_per_branch: int = 12) -> torch.Tensor:
    """(N,) complex wideband -> (M, 2K) filtered polyphase legs, re/im
    interleaved per leg: u[m, r] = sum_p g[p, r] X[m+p, r], the left
    operand of the DFT matmul.  M = (N - K*taps) // K + 1."""
    taps = taps_per_branch
    n = x.shape[0]
    m = (n - k * taps) // k + 1
    rows = m + taps - 1
    real_dt = _real_dtype(x)
    xf = torch.view_as_real(x[: rows * k].reshape(rows, k)).to(real_dt)
    g = _on_device("taps", k, taps, x.device, real_dt)[:, :, None]
    acc = torch.zeros((m, k, 2), dtype=real_dt, device=x.device)
    for p in range(taps):                # in the JAX package's order
        acc = acc + xf[p: p + m] * g[p]
    return acc.reshape(m, 2 * k)


def channelize_cols(x: torch.Tensor, kern, k: int,
                    taps_per_branch: int = 12) -> torch.Tensor:
    """Channelize against an explicit (2K, C, 2) dft_kernel slice (tensor
    or numpy): the (C, M) basebands of the C channels whose kernel columns
    were passed, contiguous.  With the whole dft_kernel(k) this is
    channelize()."""
    return dft_columns(polyphase_legs(x, k, taps_per_branch), kern, k)


def dft_columns(legs: torch.Tensor, kern, k: int) -> torch.Tensor:
    """The DFT step of channelize_cols on polyphase_legs' (M, 2K) output:
    the (C, M) basebands of the kernel columns passed (a mesh receiver's
    shards on one device share the legs)."""
    kf = torch.as_tensor(kern).to(legs.device, legs.dtype)
    c = kf.shape[1]
    # the products of the (float32) legs and kernel are exact in float64;
    # summed there and rounded once, the result does not depend on the
    # order cuBLAS or the host's BLAS sums in (and TF32 cannot reach it)
    wide = torch.float64
    y = (legs.to(wide) @ kf.reshape(2 * k, 2 * c).to(wide)).to(legs.dtype)
    y = y.reshape(-1, c, 2)
    # (M, C, 2) -> (C, M) complex: one copy, so the engine's reshape into
    # window rows reads it as it is
    return torch.view_as_complex(y.permute(1, 0, 2).contiguous())


def channelize(x: torch.Tensor, k: int,
               taps_per_branch: int = 12) -> torch.Tensor:
    """(N,) complex wideband at K*fs_ch -> (K, M) complex channel
    basebands at fs_ch, on x's device (the module docstring has the
    formulation)."""
    kern = _on_device("dft", k, taps_per_branch, x.device, _real_dtype(x))
    return channelize_cols(x, kern, k, taps_per_branch)


def msk_wideband(frames_u8, k: int, device="cuda") -> torch.Tensor:
    """Simulation helper: the OPV MSK waveform of (F, 134) frames
    synthesized at the wideband rate (K x 2.168 Msamples/s), the fast TX's
    math with the phase increments scaled by 1/K (period 160K samples,
    40K samples per symbol), plus the 100-symbol zero flush: (n,)
    complex128 on `device`.  Narrowband by construction (no upsampling
    images), so quiet channels of a synthesize_wideband placement stay
    quiet."""
    from opv_tpu_torch.core.framing import encode_frame, frame_to_symbol_bits
    from opv_tpu_torch.tx.modulator import mod_reset, symbol_signs
    dev = torch.device(device)
    frames = (frames_u8.to(dev, torch.uint8)
              if isinstance(frames_u8, torch.Tensor)
              else torch.from_numpy(np.asarray(frames_u8, np.uint8)).to(dev))
    bits = frame_to_symbol_bits(encode_frame(frames)).reshape(-1)
    st = mod_reset()
    d1, d2, _, _ = symbol_signs(bits, st.t_xor, st.b_n)
    sps = CONFIG.samples_per_symbol * k
    period = 160 * k                     # 4 symbols
    f64 = dict(dtype=torch.float64, device=dev)
    ph = 2 * math.pi * torch.arange(period, **f64) / period
    sin, cos = torch.sin(ph), torch.cos(ph)
    # the waveform repeats every 4 symbols: (S/4, 160K) rows, one sin/cos row
    a1 = d1.to(torch.float64).reshape(-1, 4).repeat_interleave(sps, dim=1)
    a2 = d2.to(torch.float64).reshape(-1, 4).repeat_interleave(sps, dim=1)
    amp = CONFIG.iq_amplitude
    sig = torch.complex((a2 - a1) * sin * amp, (a2 + a1) * cos * amp)
    return torch.cat([sig.reshape(-1),
                      torch.zeros(100 * sps, dtype=torch.complex128,
                                  device=dev)])


def wideband_test_channels(k: int) -> list:
    """Two distinct channel indices for wideband smoke signals at any K
    (for K <= 2 the naive {1 % k, (k//2) % k} picks collapse to one)."""
    idx = list(dict.fromkeys([1 % k, (k // 2) % k, 0, max(k - 1, 0)]))
    return idx[: min(2, k)]


def synthesize_wideband(channel_signals: dict, k: int, n: int,
                        device="cuda") -> torch.Tensor:
    """Simulation helper: place signals already sampled at the wideband
    rate on the channelizer grid by direct frequency shift and summation:
    {channel c: (<= n,) complex signal (numpy or tensor)} -> (n,)
    complex128 on `device`."""
    dev = torch.device(device)
    out = torch.zeros(n, dtype=torch.complex128, device=dev)
    for c, s in channel_signals.items():
        s = torch.as_tensor(s).to(dev, torch.complex128)
        m = min(s.shape[0], n)
        theta = 2 * math.pi * c * torch.arange(m, dtype=torch.float64,
                                               device=dev) / k
        out[:m] += s[:m] * torch.polar(torch.ones_like(theta), theta)
        del theta
    return out
