"""Dispatch between the hand-written CUDA kernels and their plain twins.

The device of the input decides: a CPU tensor runs the twin, a CUDA tensor
runs the kernel, and a kernel that fails to build or launch raises — there
is no silent fallback that could hide the device or a kernel.  The Viterbi
radix (2 or 4, default 4) comes from OPV_VITERBI_RADIX or
set_viterbi_radix(); both radices decode identically.
"""

from __future__ import annotations

import os

import torch

from opv_tpu_torch.ops import phase_track as _phase
from opv_tpu_torch.ops import symbol_soft as _soft
from opv_tpu_torch.ops import viterbi as _vit

_radix = int(os.environ.get("OPV_VITERBI_RADIX", "4"))


def set_viterbi_radix(radix: int) -> None:
    global _radix
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    _radix = radix


def get_viterbi_radix() -> int:
    return _radix


def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "twin"
    raise ValueError(f"no kernel or twin for device {t.device}")


def viterbi_batch(soft: torch.Tensor):
    """(B, 2144) int32 -> (bits (B, 1072) uint8, metrics (B,) int32)."""
    if _route(soft) == "cuda":
        return _vit.CUDA_KERNELS[_radix](soft.to(torch.int32).contiguous())
    return _vit.viterbi_reference(soft, _radix)


def symbol_soft(rows, kern, resc, phi, nsym: int) -> torch.Tensor:
    """The fused soft stage (ops/symbol_soft.py contract) -> (C, nsym)."""
    if _route(rows) == "cuda":
        return _soft.symbol_soft_cuda(rows, kern, resc, phi, nsym)
    return _soft.symbol_soft_reference(rows, kern, resc, phi, nsym)


def phase_track(ph0, incs, n: int):
    """The exact modulator's serial phase recurrence (ops/phase_track.py
    contract) -> (phases (T, n), final (T,)) float64."""
    if _route(ph0) == "cuda":
        return _phase.phase_track_cuda(ph0, incs, n)
    return _phase.phase_track_reference(ph0, incs, n)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset (the soft stage
    once per row type)."""
    return {"viterbi_r4": _vit.viterbi_r4_cuda.launches,
            "viterbi_r2": _vit.viterbi_r2_cuda.launches,
            **{f"symbol_soft[{rows}]": n
               for rows, n in _soft.symbol_soft_cuda.launches.items()},
            "phase_track": _phase.phase_track_cuda.launches}


def reset_launch_counts() -> None:
    _vit.viterbi_r4_cuda.launches = 0
    _vit.viterbi_r2_cuda.launches = 0
    _phase.phase_track_cuda.launches = 0
    for rows in _soft.symbol_soft_cuda.launches:
        _soft.symbol_soft_cuda.launches[rows] = 0
