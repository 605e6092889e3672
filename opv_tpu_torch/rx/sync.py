"""Sync word pattern and the shared energy-normalized sync metric."""

from __future__ import annotations

import functools

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG


@functools.lru_cache(maxsize=None)
def sync_pattern() -> np.ndarray:
    """+1/-1 expected soft signs: bit 1 -> -1 (F1 tone), bit 0 -> +1."""
    bits = np.array(CONFIG.sync_pattern_bits())
    return np.where(bits == 1, -1.0, 1.0)


def normalized_sync(raw: torch.Tensor, energy: torch.Tensor) -> torch.Tensor:
    """raw / energy with the min-energy gate (energy < 100 -> 0)."""
    safe = torch.where(energy > 0, energy, torch.ones_like(energy))
    return torch.where(energy < CONFIG.sync_min_energy,
                       torch.zeros_like(raw), raw / safe)
