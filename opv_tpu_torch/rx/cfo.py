"""Coarse carrier-frequency-offset estimate as batched complex matmuls.

Per-symbol correlation energy is invariant to the LO's inter-symbol phase,
so the reference's serial grid search (121 coarse offsets of 25 Hz, then
13 fine offsets of 5 Hz) is one (nsym, 40) x (40, 2*O) contraction per
stage.  First-occurrence argmax and the strict "fine beats coarse" rule
match the reference's selection."""

from __future__ import annotations

import math

import torch

from opv_tpu_torch.config import CONFIG

_TWO_PI = 2.0 * math.pi


def grid_energies(samples: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(C, N) complex64 and (C, O) Hz -> (C, O) float32 total correlation
    energy of both tones over the first min(N/40, 1000) symbols.  The LO
    tables are built in float64, then rounded to the samples' dtype."""
    sps = CONFIG.samples_per_symbol
    c, n = samples.shape
    nsym = min(n, sps * CONFIG.cfo_max_symbols) // sps
    sym = samples[:, : nsym * sps].reshape(c, nsym, sps)
    i = torch.arange(sps, dtype=torch.float64, device=samples.device)
    freqs = torch.stack([-CONFIG.freq_dev + offsets,
                         CONFIG.freq_dev + offsets], dim=-1)       # (C, O, 2)
    ph = -(_TWO_PI / CONFIG.sample_rate) * freqs[..., None] * i
    e = torch.polar(torch.ones_like(ph), ph).to(samples.dtype)
    corr = torch.einsum("csi,coti->csot", sym, e)
    return (corr.real ** 2 + corr.imag ** 2).sum(dim=(1, 3))


def estimate_cfo_batch(samples: torch.Tensor) -> torch.Tensor:
    """(C, N) complex -> (C,) float64 Hz (callers cast to float32).

    On a clean MSK capture the energy curve is flat to ~1e-6 over +-75 Hz
    around its peak, so the grid argmax there is decided by float32
    rounding; rx_locked's feed-forward refinement removes the difference."""
    c = samples.shape[0]
    dev = samples.device

    def select(grid, e):
        k = torch.argmax(e, dim=-1, keepdim=True)
        return grid.gather(1, k)[:, 0], e.gather(1, k)[:, 0]

    span, step = CONFIG.cfo_coarse_span_hz, CONFIG.cfo_coarse_step_hz
    coarse = torch.arange(-span, span + step / 2, step, dtype=torch.float64,
                          device=dev).expand(c, -1)
    coarse_best, coarse_e = select(coarse, grid_energies(samples, coarse))
    fspan, fstep = CONFIG.cfo_fine_span_hz, CONFIG.cfo_fine_step_hz
    fine = coarse_best[:, None] + torch.arange(
        -fspan, fspan + fstep / 2, fstep, dtype=torch.float64, device=dev)
    fine_best, fine_e = select(fine, grid_energies(samples, fine))
    return torch.where(fine_e > coarse_e, fine_best, coarse_best)



def estimate_cfo(samples: torch.Tensor) -> torch.Tensor:
    """(N,) complex -> 0-d float64 Hz: estimate_cfo_batch of one channel
    (opv_tpu's single-channel estimate_cfo has the same grids and
    selection; on complex128 the two agree exactly)."""
    return estimate_cfo_batch(samples[None])[0]
