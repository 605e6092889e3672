"""The plain reference of the OPV receiver the benchmark holds the program to.

Plain PyTorch (any device, float64 where it computes), written from the air
interface's definition (opv-cxx-demod: opv-mod.cpp, opv-demod.cpp) and
importing nothing of the program:

  * the transmit side's tables: the CCSDS randomizer mask, the K=7 rate-1/2
    convolutional code (G1 0x4F, G2 0x6D), the 67x32 interleaver with its
    per-byte bit reversal and the 24-bit sync word, so the traffic generator
    can build frames and the reference can judge them;
  * the analysis channelizer of a wideband stream: channel c is
    decimate_K(lowpass_h(x[n] e^{-j2 pi c n/K})), h the Kaiser-windowed sinc
    of the configuration, channel sample m filtering the K * taps wideband
    samples from mK on, computed here circularly over one period of a
    periodic stream through the FFT (not the program's polyphase legs);
  * the locked-grid soft value of each symbol at a given sync position,
    sub-sample timing and carrier offset: the energy of the +f_dev tone
    correlation minus that of the -f_dev one over the 41 samples
    [P, P + 40] weighted (1 - frac, 1, ..., 1, frac);
  * the sync quality, the reference's 3-bit soft quantizer, the
    deinterleaver and the Viterbi path metric (the least over end states).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPS = 40                      # samples per symbol
SYNC_BITS = 24
ENC_BITS = 2144               # encoded bits a frame
FRAME_BITS = 1072
FRAME_BYTES = 134
FRAME_SYMBOLS = SYNC_BITS + ENC_BITS          # 2168
SPF = FRAME_SYMBOLS * SPS                     # 86,720 samples a frame
SAMPLE_RATE = 2_168_000.0
FREQ_DEV = 13_550.0
AMPLITUDE = 16383.0
SYNC_WORD = 0x02B8DB
G1_MASK, G2_MASK = 0x4F, 0x6D
ROWS, COLS = 67, 32
LFSR_SEED = 0xFF
SOFT_MAX = 7
SYNC_MIN_ENERGY = 100.0


def randomizer_mask() -> np.ndarray:
    """The 134-byte CCSDS keystream (x^8+x^7+x^5+x^3+1, seed 0xFF, MSB
    first), re-seeded every frame."""
    state = LFSR_SEED
    out = np.zeros(FRAME_BYTES, np.uint8)
    for i in range(FRAME_BYTES):
        b = 0
        for bit in range(7, -1, -1):
            b |= ((state >> 7) & 1) << bit
            fb = ((state >> 7) ^ (state >> 6) ^ (state >> 4)
                  ^ (state >> 2)) & 1
            state = ((state << 1) | fb) & 0xFF
        out[i] = b
    return out


def interleave_dest() -> np.ndarray:
    """Where encoded bit i lands on the air: row-major into 67 rows of 32,
    read out by columns, then each byte's bits reversed."""
    i = np.arange(ENC_BITS)
    pos = (i % COLS) * ROWS + i // COLS
    return (pos // 8) * 8 + (7 - pos % 8)


def sync_bits() -> np.ndarray:
    return np.array([(SYNC_WORD >> (SYNC_BITS - 1 - i)) & 1
                     for i in range(SYNC_BITS)], np.uint8)


def _taps(mask: int) -> list:
    """Delays of a generator: register bit 6 is the current input (delay 0)
    and bit k <= 5 the input k + 1 steps back."""
    return ([0] if (mask >> 6) & 1 else []) + [k + 1 for k in range(6)
                                                if (mask >> k) & 1]


def encode_symbols(payload: torch.Tensor) -> torch.Tensor:
    """(..., 134) uint8 frames -> (..., 2168) uint8 symbol bits on the air:
    the sync word, then the randomized frame (last byte first, MSB first)
    convolutionally encoded (g1, g2 per input bit, from an all-zero
    register, truncated) and interleaved."""
    dev = payload.device
    mask = torch.from_numpy(randomizer_mask()).to(dev)
    rnd = (payload.to(torch.uint8) ^ mask).flip(-1)
    shifts = torch.arange(7, -1, -1, device=dev, dtype=torch.uint8)
    u = ((rnd[..., :, None] >> shifts) & 1).reshape(*rnd.shape[:-1], -1)
    up = torch.nn.functional.pad(u, (6, 0))

    def gen(mask_bits):
        out = torch.zeros_like(u)
        for d in _taps(mask_bits):
            out ^= up[..., 6 - d: 6 - d + FRAME_BITS]
        return out

    enc = torch.stack([gen(G1_MASK), gen(G2_MASK)], -1).reshape(
        *u.shape[:-1], ENC_BITS)
    air = torch.empty_like(enc)
    air[..., torch.from_numpy(interleave_dest()).to(dev)] = enc
    sync = torch.from_numpy(sync_bits()).to(dev).expand(
        *enc.shape[:-1], SYNC_BITS)
    return torch.cat([sync, air], -1)


def msk_amplitudes(bits: torch.Tensor):
    """(C, S) symbol bits -> the MSK symbol amplitudes (A, B), each (C, S)
    float32 in {-1, +1}, of a modulator already running (its gating sign
    t = +1 and b_n = 1 at symbol 0): the waveform is A sin(2 pi t/160) +
    j B cos(2 pi t/160) at sample time t.  A bit 0 sends the +f_dev tone,
    a bit 1 the -f_dev one."""
    b = bits.to(torch.int32)
    ones_before = torch.cumsum(b, -1) - b
    t = 1 - 2 * (ones_before & 1)
    k = torch.arange(b.shape[-1], device=b.device)
    bn = 1 - (k & 1)                       # 1, 0, 1, 0, ...
    d1 = (1 - b) * t
    d2 = torch.where(bn == 0, -b, b) * t
    return (d2 - d1).to(torch.float32), (d2 + d1).to(torch.float32)


def prototype_filter(k: int, taps: int, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc, cutoff at half the channel spacing, length
    K * taps, unit DC gain (float64)."""
    n = k * taps
    t = np.arange(n) - (n - 1) / 2
    h = np.sinc(t / k) * np.kaiser(n, beta)
    return h / h.sum()


def channelize_periodic(x: torch.Tensor, k: int,
                        h: np.ndarray) -> torch.Tensor:
    """One period (N,) of a periodic wideband stream -> (C, N/K) complex128
    channel outputs: channel sample m filters the L = len(h) wideband
    samples from mK on, y_c[m] = sum_t h[t] z[mK + L - 1 - t] with
    z[n] = x[n] e^{-j 2 pi c n/K} (indices mod N), up to a constant phase
    a channel.  Mixing by c/K of the rate is a shift of the spectrum by
    cN/K bins, and taking every K-th output folds the spectrum into N/K
    bins."""
    n = x.shape[0]
    if n % k:
        raise ValueError("the period must be a multiple of K")
    dev = x.device
    hp = torch.zeros(n, dtype=torch.complex128, device=dev)
    hp[: h.shape[0]] = torch.from_numpy(h).to(dev, torch.complex128)
    spec_h = torch.fft.fft(hp)
    del hp
    # the causal filter ending at mK + L - 1 is the one ending at mK of the
    # stream advanced by L - 1 samples
    spec = torch.fft.fft(torch.roll(x.to(torch.complex128),
                                    -(h.shape[0] - 1)))
    m = n // k
    out = []
    for c in range(k):
        z = torch.roll(spec, -c * m) * spec_h
        out.append(torch.fft.ifft(z.reshape(k, m).sum(0)) / k)
    return torch.stack(out)


def soft_values(seg: torch.Tensor, frac: torch.Tensor,
                foff: torch.Tensor) -> torch.Tensor:
    """(F, L) complex channel samples, each row starting at a frame's sync
    position (L >= 2168 * 40 + 1), with the sub-sample timing frac (F,) and
    carrier offset foff (F,) Hz -> (F, 2168) float64 soft values
    |corr(+f_dev)|^2 - |corr(-f_dev)|^2 over the weighted 41-sample
    windows."""
    f = seg.shape[0]
    seg = seg.to(torch.complex128)
    dev = seg.device
    t = torch.arange(SPS + 1, dtype=torch.float64, device=dev)
    w = torch.ones((f, SPS + 1), dtype=torch.float64, device=dev)
    fr = frac.to(dev, torch.float64)
    w[:, 0] = 1.0 - fr
    w[:, SPS] = fr
    tones = torch.stack([-FREQ_DEV + foff.to(dev, torch.float64),
                         FREQ_DEV + foff.to(dev, torch.float64)], -1)
    ph = (2 * math.pi / SAMPLE_RATE) * tones[:, None, :] * t[None, :, None]
    kern = w[:, :, None] * torch.exp(-1j * ph)           # (F, 41, 2)
    win = seg[:, : FRAME_SYMBOLS * SPS + 1]
    rows = win[:, :-1].reshape(f, FRAME_SYMBOLS, SPS)
    nxt = torch.cat([rows[:, 1:, :1], win[:, -1:, None]], 1)
    sym = torch.cat([rows, nxt], -1)                     # (F, 2168, 41)
    corr = torch.einsum("fst,fti->fsi", sym, kern)
    p = corr.real ** 2 + corr.imag ** 2
    return p[..., 1] - p[..., 0]


def sync_quality(soft: torch.Tensor) -> torch.Tensor:
    """(F, >= 24) soft -> (F,) the sync correlation over its energy
    (0 below the minimum energy): +1 is every sync symbol on its tone."""
    pat = torch.from_numpy(1.0 - 2.0 * sync_bits()).to(soft.device,
                                                       torch.float64)
    w = soft[:, :SYNC_BITS]
    raw = (w * pat).sum(-1)
    energy = w.abs().sum(-1)
    safe = torch.where(energy > 0, energy, torch.ones_like(energy))
    return torch.where(energy < SYNC_MIN_ENERGY, torch.zeros_like(raw),
                       raw / safe)


def quantize(payload_soft: torch.Tensor) -> torch.Tensor:
    """(F, 2144) soft -> (F, 2144) int64 in 0..7: the reference's
    clamp(trunc((-soft / mean|soft|) * 3.5 + 3.5 + 0.5), 0, 7)."""
    scale = payload_soft.abs().mean(-1, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    n = (-payload_soft / scale) * 3.5 + 3.5
    return torch.clamp(torch.trunc(n + 0.5), 0, SOFT_MAX).to(torch.int64)


def viterbi_metric(q: torch.Tensor) -> torch.Tensor:
    """(F, 2144) quantized soft symbols as received -> (F,) the least path
    metric over the trellis (branch metric s for an expected 0, 7 - s for
    an expected 1), from the all-zero register."""
    dev = q.device
    deint = q[:, torch.from_numpy(interleave_dest()).to(dev)]
    sg = deint.reshape(q.shape[0], FRAME_BITS, 2)
    s = np.arange(64)
    inp = s & 1
    parents = [(s >> 1) + 32 * hi for hi in (0, 1)]

    def parity(v):
        return np.array([bin(int(x)).count("1") & 1 for x in v])

    exp = []
    for p in parents:
        reg = (inp << 6) | p
        exp.append((torch.from_numpy(parity(reg & G1_MASK)).to(dev),
                    torch.from_numpy(parity(reg & G2_MASK)).to(dev)))
    big = 1 << 40
    metric = torch.full((q.shape[0], 64), big, dtype=torch.int64, device=dev)
    metric[:, 0] = 0
    par = [torch.from_numpy(p).to(dev) for p in parents]
    for i in range(FRAME_BITS):
        a = sg[:, i, 0:1]
        b = sg[:, i, 1:2]
        cand = []
        for p, (e1, e2) in zip(par, exp):
            bm = (torch.where(e1 == 1, SOFT_MAX - a, a)
                  + torch.where(e2 == 1, SOFT_MAX - b, b))
            cand.append(metric[:, p] + bm)
        metric = torch.minimum(cand[0], cand[1])
    return metric.min(-1).values
