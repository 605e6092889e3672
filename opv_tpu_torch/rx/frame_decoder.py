"""Frame finisher: soft payload symbols -> decoded 134-byte frames.

scale by mean |soft|, 3-bit quantize with the reference's rule
clamp(trunc((-soft/scale)*3.5 + 3.5 + 0.5), 0, 7), deinterleave,
Viterbi, pack in reverse byte order, derandomize."""

from __future__ import annotations

import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.framing import (derandomize, device_table,
                                        pack_frame_bits)
from opv_tpu_torch.core.interleave import deinterleave_gather
from opv_tpu_torch.ops import registry


def quantize_soft(soft: torch.Tensor):
    """(B, 2144) float -> ((B, 2144) int32 in [0, 7], ok mask (B,))."""
    scale = soft.abs().mean(dim=-1, keepdim=True)
    ok = scale[..., 0] >= 1e-10           # all-zero payloads are rejected
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    n = (-soft / safe) * 3.5 + 3.5
    q = torch.clamp(torch.trunc(n + 0.5), 0, CONFIG.soft_max).to(torch.int32)
    return q, ok


def decode_payloads(soft_payloads: torch.Tensor):
    """(B, 2144) float soft symbols -> (frames (B, 134) uint8, metrics (B,)
    int32, ok (B,) bool).  Metric 0 is a perfect frame."""
    q, ok = quantize_soft(soft_payloads)
    gather = device_table(deinterleave_gather, q.device, torch.int64)
    bits, metrics = registry.viterbi_batch(q[..., gather].contiguous())
    return derandomize(pack_frame_bits(bits)), metrics, ok
