"""Non-coherent MSK demodulator with AFC + early-late symbol timing recovery
(counterpart of opv_tpu/rx/demod.py, batched over a leading channel axis).

Per symbol: integrate-and-dump correlation of linearly interpolated
on-time / early / late sample streams (early-late spacing 10 samples)
against both tone LOs; soft = |c2|^2 - |c1|^2; an early-late TED on the
dominant tone feeds a 2nd-order timing loop (alpha 0.005, beta 1e-5,
clamps 0.1 / 2.0); the AFC follows the inter-symbol phase of the dominant
tone (alpha 0.001 by default, clamp +-2000 Hz, skipped on the first symbol
of each call); the fractional position `mu` and the leftover samples carry
across streaming chunks (src/opv-demod.cpp:108-348).  The loop runs at
the samples' precision, as opv_tpu's runs at its state's: float64 on
complex128 (the reference's precision) and float32 on complex64 (the JAX
package's dtype="float32" mode, for speed).

The serial loop is ops/registry.py::track_symbols: the track_symbols CUDA
kernel on a CUDA tensor, its plain twin on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.ops import registry


class LoopState(NamedTuple):
    """The loop carry (the reference's member variables,
    opv-demod.cpp:336-347), one entry per channel; also the checkpoint
    record.  Fields in opv_tpu's order."""
    mu: torch.Tensor           # fractional symbol position (0..1)
    phase_f1: torch.Tensor
    phase_f2: torch.Tensor
    freq_offset: torch.Tensor  # Hz
    timing_freq: torch.Tensor
    prev_c1: torch.Tensor      # complex on-time correlators of the last symbol
    prev_c2: torch.Tensor


def loop_state_init(freq_offset=0.0, channels: int | None = None,
                    device="cpu", dtype=torch.float64) -> LoopState:
    """Zeros of the real dtype (float64 or float32) with the given offset
    (rounded to it); (channels,) tensors, or 0-d ones (a single channel,
    the JAX layout) when channels is None.  freq_offset may be a scalar
    or one value per channel."""
    shape = () if channels is None else (channels,)
    real = dict(dtype=dtype, device=device)
    z = torch.zeros(shape, **real)
    zc = torch.zeros(shape, dtype=complex_dtype(dtype), device=device)
    return LoopState(mu=z, phase_f1=z.clone(), phase_f2=z.clone(),
                     freq_offset=torch.as_tensor(freq_offset)
                     .to(**real).expand(shape).clone(),
                     timing_freq=z.clone(), prev_c1=zc, prev_c2=zc.clone())


def real_dtype(dtype: str) -> torch.dtype:
    """The receivers' dtype= option ("float64" or "float32") as a torch
    dtype."""
    if dtype not in ("float64", "float32"):
        raise ValueError(f"dtype must be 'float64' or 'float32', got "
                         f"{dtype!r}")
    return getattr(torch, dtype)


def complex_dtype(real: torch.dtype) -> torch.dtype:
    """float64 -> complex128, float32 -> complex64."""
    return torch.complex128 if real == torch.float64 else torch.complex64


def max_symbols(capacity: int) -> int:
    """Worst-case symbols a buffer can produce (timing_adj >= -2 => stride
    >= 38 samples/symbol)."""
    return int(capacity // (CONFIG.samples_per_symbol
                            - CONFIG.timing_adj_clamp)) + 2


def pack_state(state: LoopState) -> torch.Tensor:
    """(C,) LoopState -> the kernel's (C, 9) rows of the state's real
    dtype."""
    c1, c2 = torch.view_as_real(state.prev_c1), torch.view_as_real(state.prev_c2)
    return torch.cat([torch.stack([state.mu, state.phase_f1, state.phase_f2,
                                   state.freq_offset, state.timing_freq], -1),
                      c1, c2], -1).to(state.mu.dtype)


def unpack_state(rows: torch.Tensor) -> LoopState:
    """(C, 9) rows -> (C,) LoopState of their dtype."""
    return LoopState(mu=rows[:, 0], phase_f1=rows[:, 1], phase_f2=rows[:, 2],
                     freq_offset=rows[:, 3], timing_freq=rows[:, 4],
                     prev_c1=torch.complex(rows[:, 5], rows[:, 6]),
                     prev_c2=torch.complex(rows[:, 7], rows[:, 8]))


def demodulate_block(samples: torch.Tensor, n_valid: torch.Tensor,
                     state: LoopState, afc_alpha: float | None = None):
    """Demodulate one block of IQ per channel.

    samples: (C, CAP) complex128, or complex64 for the float32 loop (only
             the first n_valid[c] entries of row c are data).
    n_valid: (C,) int sample counts.
    state:   (C,) LoopState from the previous block; the caller prepends
             the leftover samples, as the reference's chunk loop does.

    Returns (soft (C, MAXS) of the real dtype, sym_valid (C, MAXS) bool,
    new_state, samples_used (C,) int32) with MAXS = max_symbols(CAP); the
    caller keeps samples[c, samples_used[c]:n_valid[c]] as the head of
    the next buffer.  The state is taken at the samples' precision.
    """
    if afc_alpha is None:
        afc_alpha = CONFIG.afc_alpha
    if samples.dtype not in (torch.complex128, torch.complex64):
        raise ValueError(f"samples must be complex128 or complex64, got "
                         f"{samples.dtype}")
    real = torch.float64 if samples.dtype == torch.complex128 \
        else torch.float32
    maxs = max_symbols(samples.shape[-1])
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=samples.device)
    soft, sym_valid, rows, used = registry.track_symbols(
        samples, n_valid, pack_state(state).to(samples.device, real),
        float(afc_alpha), maxs)
    return soft, sym_valid, unpack_state(rows), used
