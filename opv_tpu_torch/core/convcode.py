"""K=7 rate-1/2 convolutional encoder as an XOR of delayed bitstreams.

State bit 6 is the current input u[i] and state bit k <= 5 is u[i-1-k], so
a generator-mask bit at position 6 is delay 0 and one at k <= 5 is delay
k+1.  Zero padding at the front is the fresh all-zero shift register each
frame starts from (truncated, not terminated)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG


@functools.lru_cache(maxsize=None)
def _mask_delays(mask: int) -> tuple[int, ...]:
    delays = [0] if (mask >> 6) & 1 else []
    delays += [k + 1 for k in range(6) if (mask >> k) & 1]
    return tuple(sorted(delays))


G1_DELAYS = _mask_delays(CONFIG.g1_mask)
G2_DELAYS = _mask_delays(CONFIG.g2_mask)


def conv_encode_bits(u: torch.Tensor) -> torch.Tensor:
    """(..., N) bits -> (..., 2N) uint8 with out[2i] = g1_i, out[2i+1] = g2_i."""
    u = u.to(torch.uint8)
    n = u.shape[-1]
    up = F.pad(u, (6, 0))

    def xor_delayed(delays):
        out = None
        for d in delays:
            sl = up[..., 6 - d: 6 - d + n]
            out = sl if out is None else out ^ sl
        return out

    g = torch.stack([xor_delayed(G1_DELAYS), xor_delayed(G2_DELAYS)], dim=-1)
    return g.reshape(*u.shape[:-1], 2 * n)
