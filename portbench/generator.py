"""The general traffic generator: a configuration's input stream from a
traffic mix's parameters (portbench/traffic/<name>.json) and the seed.

Every transmitting channel carries its own frame-periodic OPV stream: a
cycle of frames of distinct payloads drawn from the seed (the least
common multiple of `period_frames`, `cycle_frames` and the receiver's
block), MSK at 2.168 Msamples/s with a seeded carrier phase and the
mix's carrier offset, its frame grid offset by
offset_c = (c * offset_stride + c % 40) % 86,720 samples, each sync at an
integer channel sample (where the receiver's 41-sample window (1/2, 1,
..., 1, 1/2) matches a symbol: its sub-sample timing sits at 0.5, far
from a grid step).  A channel of a `burst_frames` mix transmits only in
bursts of that many frames every `period_frames`, starting at frame
(c * burst_stagger) % period_frames; with `active_stride` only every
such channel transmits.  AWGN at `ebn0_db` (energy a symbol over the
noise density, as opv_tpu_torch's wideband_bench sets it) is added to
every channel, silent or not.  A wideband configuration sums the channels,
each gated on its own, onto their carriers c * 2.168 MHz of one stream at
K x 2.168 Msamples/s, the waveform evaluated at the wideband rate (no
images), with the noise at K times the density so each channel gets its
share.

The seed draws only payloads, phases and noise: the structure (offsets,
bursts, carrier offsets, lengths) is the mix's, so every seed gives the
same work.  The cycle is made on the device in a few large calls, with a
torch.Generator on the device, and fed again and again: `feeds` cuts it
into the pieces one feed() takes (one block advance of every channel, or
one wideband quantum), and a stream's modulator state closes over a cycle
(each channel's cycle holds an even number of one bits), so the
repetition is seamless.  The noise runs over `noise_frames` frames (whole
cycles), so a channel's noise does not repeat with its bursts: the
stream's period is that long.

A mix that needs another stream names its own module, `"generator":
"<name>"`, portbench/traffic/<name>.py, whose generate(config, mix, seed,
device) returns a Traffic (`make` finds it).
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from portbench import reference as ref


@dataclasses.dataclass
class Traffic:
    """One cycle of a configuration's input and what it carries."""
    kind: str                   # "wideband" or "channels"
    channels: int
    cycle_frames: int
    feeds: list                 # the cycle cut into feed() pieces
    feed_channel_samples: int   # channel samples one feed advances
    payloads: np.ndarray        # (C, cycle_frames, 134) uint8
    gate: np.ndarray            # (C, cycle_frames) bool: frame sent
    offsets: np.ndarray         # (C,) int: each channel's grid offset
    sync_at: np.ndarray         # (C,) float: frame 0's sync position,
    #                             where the receiver's p0 + frac reads
    #                             sync_at + 0.5
    cfo_hz: np.ndarray          # (C,) float: each carrier's offset, Hz
    k: int = 0                  # wideband: channels of the stream
    taps: int = 0
    beta: float = 0.0

    def frame_at(self, c: int, pos: int):
        """The frame (counted from the stream's first) whose sync lies at
        channel sample `pos` of channel c, within half a symbol, or None."""
        half = ref.SPS // 2
        j, rem = divmod(pos - int(round(self.sync_at[c])) + half, ref.SPF)
        return j if rem <= 2 * half else None

    def sent(self, c: int, j: int) -> bool:
        return bool(self.gate[c, j % self.cycle_frames])

    def payload(self, c: int, j: int) -> bytes:
        return self.payloads[c, j % self.cycle_frames].tobytes()


def offsets(channels: int, stride: int) -> np.ndarray:
    c = np.arange(channels)
    return (c * stride + c % ref.SPS) % ref.SPF


def payloads(rng, channels: int, frames: int, device) -> np.ndarray:
    """(C, frames, 134) random payloads; where a channel's cycle would hold
    an odd number of one bits, bit 2 of its first frame's byte 0 is flipped
    (that input bit reaches five coded bits, so the parity flips)."""
    p = rng.integers(0, 256, (channels, frames, ref.FRAME_BYTES),
                     dtype=np.uint8)
    bits = ref.encode_symbols(torch.from_numpy(p).to(device))
    odd = (bits.to(torch.int64).sum((1, 2)) % 2).cpu().numpy().astype(bool)
    p[odd, 0, 0] ^= 0x04
    return p


def _unit_circle(n: int, device) -> torch.Tensor:
    """e^{j 2 pi v / n} for v = 0 .. n-1 (complex128), from the C library's
    sin and cos, so a stream is the same on every run and device."""
    t = [2 * math.pi * v / n for v in range(n)]
    return torch.complex(torch.tensor([math.cos(a) for a in t],
                                      dtype=torch.float64),
                         torch.tensor([math.sin(a) for a in t],
                                      dtype=torch.float64)).to(device)


def _waveform(amp_a, amp_b, u, res: int, n_sym: int, circle):
    """The MSK baseband of one channel at channel-sample times u / res (u an
    int64 tensor), from its (n_sym,) symbol amplitudes, periodic over n_sym
    symbols: A sin(2 pi t/160) + j B cos(2 pi t/160), complex64.  `circle`
    is _unit_circle(160 * res)."""
    um = torch.remainder(u, n_sym * ref.SPS * res)
    s = um // (ref.SPS * res)
    e = circle[um % (4 * ref.SPS * res)]
    return torch.complex(amp_a[s] * e.imag.to(torch.float32),
                         amp_b[s] * e.real.to(torch.float32))


def _closed(cfo_hz, cycle_s: float) -> np.ndarray:
    """Each carrier offset rounded to a whole number of turns over a cycle,
    so a repeated cycle's phase runs on without a jump."""
    return np.round(np.asarray(cfo_hz, np.float64) * cycle_s) / cycle_s


def _rotation(n, cfo: float, rate: float, device) -> torch.Tensor:
    """e^{j 2 pi cfo n / rate} (complex64) at the int64 sample indices n."""
    ph = torch.remainder(n.to(torch.float64) * (cfo / rate), 1.0)
    return torch.polar(torch.ones_like(ph), 2 * math.pi * ph).to(
        torch.complex64)


def generate(config: dict, traffic: dict, seed: int, device) -> Traffic:
    """The cycle of `config` (portbench/configs/<name>.json) under the mix
    `traffic` (portbench/traffic/<name>.json) for `seed`.

    The mix's keys: period_frames; offset_stride; ebn0_db; optionally
    cycle_frames (the payloads' cycle is the least common multiple of it,
    period_frames and the block), burst_frames and burst_stagger (talk
    spurts), active_stride (only
    every active_stride-th channel transmits, from channel 0; the others
    carry noise alone), cfo_hz (carrier offsets, channel c taking entry
    c mod its length, each rounded to close over a cycle), noise_frames
    (the noise's period, whole cycles) and warmup_feeds."""
    dev = torch.device(device)
    inp = config["input"]
    kind = inp["kind"]
    chans = inp["k"] if kind == "wideband" else inp["channels"]
    period = traffic["period_frames"]
    bf = config["engine"]["block_frames"]
    f = math.lcm(period, bf, traffic.get("cycle_frames", 1))
    advance = bf * ref.SPF
    rng = np.random.default_rng(seed)
    pay = payloads(rng, chans, f, dev)
    phase = rng.uniform(0.0, 2 * math.pi, chans)
    gate = np.ones((chans, f), bool)
    burst = traffic.get("burst_frames")
    if burst:
        j = np.arange(f)
        for c in range(chans):
            st = c * traffic["burst_stagger"]
            gate[c] = (j - st) % period < burst
    gate[np.arange(chans) % traffic.get("active_stride", 1) != 0] = False
    cfo = np.zeros(chans)
    if "cfo_hz" in traffic:
        table = traffic["cfo_hz"]
        cfo = _closed([table[c % len(table)] for c in range(chans)],
                      f * ref.SPF / ref.SAMPLE_RATE)
    off = offsets(chans, traffic["offset_stride"])
    delay = 0.0
    if kind == "wideband":
        # channel sample m of the receiver filters the K * taps wideband
        # samples from mK on: its centre lies (K * taps - 1) / 2K channel
        # samples after m
        k, taps = inp["k"], inp["taps_per_branch"]
        delay = (k * taps - 1) / (2 * k)
    # a symbol is matched by the 41-sample window (1/2, 1, ..., 1, 1/2) at
    # an integer start; place each sync at an integer channel sample
    frac = delay - math.floor(delay)
    sync_at = off + frac - delay
    bits = ref.encode_symbols(torch.from_numpy(pay).to(dev))
    amp_a, amp_b = ref.msk_amplitudes(bits.reshape(chans, -1))
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_sym = f * ref.FRAME_SYMBOLS
    snr = 10 ** (traffic["ebn0_db"] / 10) / ref.SPS      # a sample
    sigma = ref.AMPLITUDE / math.sqrt(snr)
    cyc = f * ref.SPF
    gate_t = torch.from_numpy(gate).to(dev)
    live = [c for c in range(chans) if gate[c].any()]
    if kind == "channels":
        if frac:
            raise ValueError("channel streams place syncs at whole samples")
        n = torch.arange(cyc, dtype=torch.int64, device=dev)
        circle = _unit_circle(4 * ref.SPS, dev)
        sig = torch.zeros((chans, cyc), dtype=torch.complex64, device=dev)
        for c in live:
            tau = n - int(off[c])
            w = _waveform(amp_a[c], amp_b[c], tau, 1, n_sym, circle)
            slot = torch.remainder(tau, cyc) // ref.SPF
            rot = complex(math.cos(phase[c]), math.sin(phase[c]))
            sig[c] = w * (gate_t[c][slot] * ref.AMPLITUDE) * rot
            if cfo[c]:
                sig[c] *= _rotation(n, cfo[c], ref.SAMPLE_RATE, dev)
        del n
        step, shape, scale = advance, (chans, advance), sigma
    else:
        k = inp["k"]
        n_wb = cyc * k
        res = 2 * k
        # times in 1/2K of a channel sample: t = n/K - offset - frac, and
        # 2K frac = K taps - 1 - 2K floor(delay) is a whole number
        shift = round(2 * k * frac)
        circle = _unit_circle(4 * ref.SPS * res, dev)
        carrier = _unit_circle(k, dev)
        sig = torch.zeros(n_wb, dtype=torch.complex64, device=dev)
        nw = torch.arange(n_wb, device=dev)
        for c in live:
            u = 2 * nw - (2 * k * int(off[c]) + shift)
            w = _waveform(amp_a[c], amp_b[c], u, res, n_sym, circle)
            slot = torch.remainder(u, cyc * res) // (ref.SPF * res)
            rot = carrier[(c * torch.arange(k, device=dev)) % k] * complex(
                math.cos(phase[c]), math.sin(phase[c])) * ref.AMPLITUDE
            w *= gate_t[c][slot]
            if cfo[c]:
                w *= _rotation(nw, cfo[c], k * ref.SAMPLE_RATE, dev)
            sig += w * rot.to(torch.complex64).repeat(n_wb // k)
            del u, w, slot
        del nw
        # each channel gets its share of noise at K times the density
        step, shape, scale = advance * k, (advance * k,), sigma * math.sqrt(k)
    # the noise runs over noise_frames frames (whole cycles), so it does
    # not repeat with a channel's bursts; the stream's period is that long
    feeds = []
    for _ in range(-(-traffic.get("noise_frames", f) // f)):
        for i in range(0, sig.shape[-1], step):
            x = scale * torch.randn(shape, dtype=torch.complex64,
                                    device=dev, generator=gen)
            x += sig[..., i:i + step]
            feeds.append(x)
    del sig
    if kind == "channels":
        return Traffic("channels", chans, f, feeds, advance, pay, gate, off,
                       sync_at, cfo)
    return Traffic("wideband", chans, f, feeds, advance, pay, gate, off,
                   sync_at, cfo, k=inp["k"], taps=inp["taps_per_branch"],
                   beta=inp["kaiser_beta"])


def make(config: dict, traffic: dict, seed: int, device) -> Traffic:
    """The mix's stream: by the generator module the mix names
    (portbench/traffic/<generator>.py, its generate(config, mix, seed,
    device) giving a Traffic), or by this one."""
    gen = sys.modules[__name__]
    if "generator" in traffic:
        from portbench import plugins
        gen = plugins.load("traffic", traffic["generator"])
    return gen.generate(config, traffic, seed, device)


def channel_samples(tr: Traffic, device) -> torch.Tensor:
    """A wideband stream's channels over its period, (C, period) complex128,
    channelized by the reference's own filterbank (circular: the stream is
    periodic); None for a channel configuration, whose feeds are the
    channels."""
    if tr.kind == "channels":
        return None
    x = torch.cat(tr.feeds).to(device)
    h = ref.prototype_filter(tr.k, tr.taps, tr.beta)
    return ref.channelize_periodic(x, tr.k, h)
