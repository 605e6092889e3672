"""The reference-exact modulator's NCO phase recurrence: the hand-written
CUDA kernel (csrc/phase_track.cu) and its plain twin, one contract:

    (T,) float64 start phases ph0, T increments, n ->
        (phases (T, n) float64, final (T,) float64)
    phases[t, 0] = ph0[t], phases[t, i+1] = wrap(phases[t, i] + inc[t]),
    final[t] = wrap(phases[t, n-1] + inc[t])

wrap(p): p - 2pi if p > pi, then p + 2pi if p < -pi (opv-mod.cpp:274-279).
Replaces opv_tpu/tx/modulator.py::_phase_track (a lax.scan).  The
recurrence is serial and not periodic in the sample index, so the twin is
a loop over Python floats (IEEE double adds, as the kernel's), about as
slow as real time on a host; the kernel keeps it on the card.
"""

from __future__ import annotations

import math

import torch

from opv_tpu_torch.ops import build

_PI = math.pi
_TWO_PI = 2.0 * math.pi


def phase_track_reference(ph0: torch.Tensor, incs, n: int):
    """The plain twin: the recurrence over Python floats, on the host;
    results on ph0's device."""
    rows, finals = [], []
    for p0, inc in zip(ph0.tolist(), incs):
        ph, row = p0, []
        append = row.append
        for _ in range(n):
            append(ph)
            p = ph + inc
            if p > _PI:
                p -= _TWO_PI
            if p < -_PI:
                p += _TWO_PI
            ph = p
        rows.append(row)
        finals.append(ph)
    f64 = dict(dtype=torch.float64, device=ph0.device)
    return (torch.tensor(rows, **f64).reshape(len(incs), n),
            torch.tensor(finals, **f64))


def phase_track_cuda(ph0: torch.Tensor, incs, n: int):
    """The kernel: one thread per tone (1 or 2 tones) on ph0's stream."""
    if not ph0.is_cuda:
        raise ValueError("the CUDA phase_track kernel needs a CUDA tensor")
    t = len(incs)
    if ph0.dtype != torch.float64 or ph0.shape != (t,) or t not in (1, 2):
        raise ValueError(f"ph0 must be (T,) float64 with T = len(incs) in "
                         f"(1, 2), got {tuple(ph0.shape)} {ph0.dtype}, "
                         f"{t} increments")
    ph0 = ph0.contiguous()
    phases = torch.empty((t, n), dtype=torch.float64, device=ph0.device)
    final = torch.empty((t,), dtype=torch.float64, device=ph0.device)
    lib = build.library()
    err = lib.opv_phase_track(ph0.data_ptr(), float(incs[0]),
                              float(incs[-1]), t, n, phases.data_ptr(),
                              final.data_ptr(), build.stream_ptr(ph0))
    build.check(lib, err, "phase_track")
    phase_track_cuda.launches += 1
    return phases, final


phase_track_cuda.launches = 0
