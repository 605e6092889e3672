"""The seeded AWGN captures of the BER tools, byte for byte the JAX
package's recipes (tools/ber_headtohead.py, tools/ber_curve.py,
tools/timing_pin_probe.py).

The transmitter runs on the chosen device (the exact TX is the
phase_track kernel on a card); the noise is drawn with numpy on the host,
so one seed gives the same capture on any machine.  Eb/N0 is the
per-sample SNR x 40 samples a symbol (BASELINE.md's convention)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
from opv_tpu_torch.tx.modulator import modulate_frames, tx_flush_zeros

CALLSIGN = "W5NYV"


def bert_frames(n_frames: int, wrap: bool = True) -> np.ndarray:
    """(n_frames, 134) uint8 BERT frames numbered 0, 1, ... (mod 256 when
    wrap, as the head-to-head recipe numbers them)."""
    num = np.arange(n_frames)
    return build_bert_frame(CALLSIGN, frame_num=num % 256 if wrap else num)


def transmit(frames: np.ndarray, exact: bool, device) -> np.ndarray:
    """The frames' int16 wire IQ, (N, 2) on the host: the exact (reference)
    or fast TX on `device`, then the 100-symbol zero flush."""
    dev = torch.device(device)
    enc = encode_frame(torch.from_numpy(frames).to(dev))
    iq, _ = modulate_frames(enc, exact=exact)
    return torch.cat([iq, tx_flush_zeros(device=dev)]).cpu().numpy()


def signal_power(s: np.ndarray, n_frames: int) -> float:
    """Mean |s|^2 over the first n_frames frames (the flush excluded)."""
    return float(np.mean(np.abs(s[: n_frames * CONFIG.samples_per_frame])
                         ** 2))


def noise_power(sig_pow: float, ebn0_db: float) -> float:
    return sig_pow / (10 ** (ebn0_db / 10) / CONFIG.samples_per_symbol)


def exact_signal(n_frames: int, device):
    """The head-to-head transmission: (truth frames, complex128 samples,
    signal power)."""
    frames = bert_frames(n_frames)
    iq = transmit(frames, exact=True, device=device)
    s = iq[:, 0].astype(np.float64) + 1j * iq[:, 1].astype(np.float64)
    return frames, s, signal_power(s, n_frames)


def headtohead_wire(s: np.ndarray, sig_pow: float, seed: int,
                    ebn0_db: float, lead: int) -> np.ndarray:
    """One head-to-head capture, (N + lead, 2) little-endian int16: the
    stream default_rng([seed, round(10 dB)]) draws the capture's noise,
    then `lead` noise-only samples that go in front, and the sum is
    truncated toward zero to the radio's int16 wire."""
    rng = np.random.default_rng([seed, int(round(ebn0_db * 10))])
    npow = noise_power(sig_pow, ebn0_db)
    noisy = s + (rng.standard_normal(len(s))
                 + 1j * rng.standard_normal(len(s))) * np.sqrt(npow / 2)
    if lead:
        noisy = np.concatenate([
            (rng.standard_normal(lead) + 1j * rng.standard_normal(lead))
            * np.sqrt(npow / 2), noisy])
    wire = np.empty((len(noisy), 2), dtype="<i2")
    wire[:, 0] = np.clip(np.trunc(noisy.real), -32768, 32767)
    wire[:, 1] = np.clip(np.trunc(noisy.imag), -32768, 32767)
    return wire


def wire_to_complex(wire: np.ndarray) -> np.ndarray:
    """(N, 2) int16 -> (N,) complex128."""
    return wire[:, 0].astype(np.float64) + 1j * wire[:, 1].astype(np.float64)


def fast_signal(n_frames: int, device):
    """The sweep's transmission (tools/ber_curve.py, tests/test_ber.py):
    frames numbered 0..n-1, the fast TX as complex64; (truth frames,
    samples, signal power)."""
    frames = bert_frames(n_frames, wrap=False)
    iq = transmit(frames, exact=False, device=device)
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    return frames, s, signal_power(s, n_frames)


def awgn(s: np.ndarray, sig_pow: float, rng: np.random.Generator,
         ebn0_db: float) -> np.ndarray:
    """s plus complex AWGN at ebn0_db from `rng` (complex128, no lead): the
    sweep draws every point from one generator, in order."""
    npow = noise_power(sig_pow, ebn0_db)
    return s + (rng.standard_normal(len(s))
                + 1j * rng.standard_normal(len(s))) * np.sqrt(npow / 2)


def card_name() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None
    where there is no nvidia-smi."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return smi.stdout.strip().splitlines()[0].strip()


def fast_stream(n_frames: int, device, start: int = 0):
    """The fast TX of BERT frames numbered start, start + 1, ... on
    `device`, with the 100-symbol zero flush: ((N,) complex64 on the
    device, the (n_frames, 134) uint8 frames on the host)."""
    from opv_tpu_torch.tx.modulator import iq_int16_to_complex
    frames = build_bert_frame(CALLSIGN, frame_num=start + np.arange(n_frames))
    dev = torch.device(device)
    iq, _ = modulate_frames(encode_frame(torch.from_numpy(frames).to(dev)))
    return (iq_int16_to_complex(torch.cat([iq, tx_flush_zeros(device=dev)])),
            frames)


def smoke_signal(channels: int, n_frames: int, device):
    """bench.py's geometry (bench.py:76-77), synthesized on `device`: one
    fast-TX stream of n_frames on every channel, channel c delayed by
    (c % 40) + 487 c samples, the length a multiple of 40.  Returns ((C, N)
    complex64, the frames, the delays)."""
    s, frames = fast_stream(n_frames, device)
    delays = [(c % 40) + 487 * c for c in range(channels)]
    n = -(-(len(s) + max(delays)) // 40) * 40
    x = torch.zeros((channels, n), dtype=torch.complex64, device=s.device)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s
    return x, frames, delays
