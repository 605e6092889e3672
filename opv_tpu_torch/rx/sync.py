"""Sync acquisition and tracking: the 24-tap soft correlator, the shared
energy-normalized sync metric and the HUNTING/VERIFYING/LOCKED flywheel
state machine (counterpart of opv_tpu/rx/sync.py, batched over a leading
channel axis).

The correlation for every symbol position is computed up front as 24
shifted adds; the state machine runs as a serial kernel over the symbols
and emits (frame ready, sync quality, transition event) per symbol; the
payload windows are gathered afterwards from the contiguous soft stream (a
frame completing at symbol t has payload soft[t-2143 .. t]).  Thresholds
0.85/0.70, raw 5000, min energy 100, miss limit 5, and the reference's
collection timing (opv-demod.cpp:587-787)."""

from __future__ import annotations

import functools
from typing import NamedTuple

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


#: transition codes emitted per symbol by sync_scan (the reference's
#: stderr diagnostics, src/opv-demod.cpp:651-706)
EV_NONE, EV_HUNT_VERIFY, EV_VERIFY_LOCK, EV_SYNC_OK, EV_SYNC_MISS, \
    EV_LOSE_LOCK = range(6)


class SyncTrackerState(NamedTuple):
    """The state machine's carry, one entry per channel; fields in
    opv_tpu's order."""
    state: torch.Tensor       # int32: 0 HUNT / 1 VERIFY / 2 LOCKED
    sss: torch.Tensor         # int32 symbols_since_sync
    misses: torch.Tensor      # int32 consecutive sync misses
    sync_q: torch.Tensor      # float sync quality at the last detection
    collecting: torch.Tensor  # bool
    total: torch.Tensor       # int32 symbols seen, saturating at 2^30
    frames: torch.Tensor      # int32 frames emitted


def sync_tracker_init(channels: int | None = None, device="cpu",
                      dtype=torch.float64) -> SyncTrackerState:
    """HUNTING, zeros, sync_q of the real dtype (float64 or float32, the
    soft stream's); (channels,) tensors, or 0-d ones (a single channel,
    the JAX layout) when channels is None."""
    shape = () if channels is None else (channels,)
    i32 = dict(dtype=torch.int32, device=device)
    return SyncTrackerState(
        state=torch.zeros(shape, **i32), sss=torch.zeros(shape, **i32),
        misses=torch.zeros(shape, **i32),
        sync_q=torch.zeros(shape, dtype=dtype, device=device),
        collecting=torch.zeros(shape, dtype=torch.bool, device=device),
        total=torch.zeros(shape, **i32), frames=torch.zeros(shape, **i32))


def sync_correlate(soft_ext: torch.Tensor):
    """Correlate every 24-symbol window against the sync pattern.

    soft_ext: (..., 23 + S) soft symbols, the first 23 history (zeros at
    stream start, the reference's zero-initialized ring buffer).  Returns
    (raw, norm), each (..., S): the raw correlation and the
    energy-normalized one with the min-energy gate (opv-demod.cpp:743-757).
    The 24 shifted adds run in opv_tpu's order, so raw and energy round the
    same on every device.
    """
    s = soft_ext.shape[-1] - (CONFIG.sync_bits - 1)
    raw = torch.zeros(soft_ext.shape[:-1] + (s,), dtype=soft_ext.dtype,
                      device=soft_ext.device)
    energy = torch.zeros_like(raw)
    for i, sign in enumerate(sync_pattern().tolist()):
        w = soft_ext[..., i:i + s]
        raw = raw + w * sign
        energy = energy + w.abs()
    return raw, normalized_sync(raw, energy)


def sync_scan(state: SyncTrackerState, raw: torch.Tensor, norm: torch.Tensor,
              valid: torch.Tensor):
    """Run the state machine over S symbols of C channels ((C, S) raw, norm
    and valid; invalid steps are no-ops).

    Returns (new_state, ready (C, S) bool, sync_q_at_emit (C, S), events
    (C, S) int32 EV_* codes, ev_misses (C, S) int32 misses after the step,
    ev_frames (C, S) int32 frames after the step).  Through
    ops/registry.py::sync_scan: the sync_scan CUDA kernel on a CUDA
    tensor, its plain twin on a CPU tensor.
    """
    # imported here: ops/ imports this module
    from opv_tpu_torch.ops import registry
    ints2, q2, ready, q, events, ev_misses, ev_frames = registry.sync_scan(
        raw, norm, valid, *_carry(state, raw))
    return (_tracker(ints2, q2), ready, q, events, ev_misses, ev_frames)


def sync_correlate_scan(state: SyncTrackerState, soft_ext: torch.Tensor,
                        valid: torch.Tensor):
    """sync_correlate, then sync_scan, in one: soft_ext (C, 23 + S) soft
    symbols, float64 or float32 (23 of history first; any row stride,
    e.g. the view soft_cat[:, eb - 23:]), valid (C, S).

    Returns (new_state, raw, norm, ready, q, events, ev_misses,
    ev_frames), each as the two functions give it.  Through
    ops/registry.py::sync_correlate_scan: one launch of the sync_scan
    kernel with the correlation as its input stage on a CUDA tensor;
    sync_correlate and the machine's twin on a CPU tensor.
    """
    from opv_tpu_torch.ops import registry
    (ints2, q2, ready, q, events, ev_misses, ev_frames, raw,
     norm) = registry.sync_correlate_scan(soft_ext, valid,
                                          *_carry(state, soft_ext))
    return (_tracker(ints2, q2), raw, norm, ready, q, events, ev_misses,
            ev_frames)


def _carry(state: SyncTrackerState, like: torch.Tensor):
    """The state as the kernel's (C, 6) int32 carry and (C,) sync_q, on
    like's device and in its real dtype."""
    ints = torch.stack([state.state, state.sss, state.misses,
                        state.collecting.to(torch.int32), state.total,
                        state.frames], -1).to(torch.int32)
    return ints.to(like.device), state.sync_q.to(like.device, like.dtype)


def _tracker(ints: torch.Tensor, sync_q: torch.Tensor) -> SyncTrackerState:
    return SyncTrackerState(state=ints[:, 0], sss=ints[:, 1],
                            misses=ints[:, 2], sync_q=sync_q,
                            collecting=ints[:, 3] != 0, total=ints[:, 4],
                            frames=ints[:, 5])


def extract_payload_windows(soft_cat: torch.Tensor, ready: torch.Tensor,
                            q: torch.Tensor, max_frames: int):
    """Gather fixed-capacity payload slots from the soft stream.

    soft_cat: (C, H + S), H = encoded_bits history symbols before this
    block's S symbols; ready/q: (C, S) from sync_scan.  A frame ready at
    local index t has payload soft_cat[c, H + t - 2143 : H + t + 1].
    Slots fill in symbol order (the first max_frames ready symbols, as
    jnp.nonzero(size=..., fill_value=-1)), by a cumulative count on the
    device.

    Returns (payloads (C, max_frames, 2144), sync_q (C, max_frames),
    slot_valid (C, max_frames), t_idx (C, max_frames) int64 local end
    indices, -1 in an empty slot).
    """
    eb = CONFIG.encoded_bits
    c, s = ready.shape
    dev = soft_cat.device
    h = soft_cat.shape[-1] - s
    slot = ready.to(torch.int64).cumsum(-1) - 1
    slot = torch.where(ready & (slot < max_frames), slot, max_frames)
    t_idx = torch.full((c, max_frames + 1), -1, dtype=torch.int64, device=dev)
    t_idx.scatter_(1, slot, torch.arange(s, device=dev).expand(c, s))
    t_idx = t_idx[:, :max_frames]
    slot_valid = t_idx >= 0
    starts = (h + t_idx - (eb - 1)).clamp(0, soft_cat.shape[-1] - eb)
    cols = starts[:, :, None] + torch.arange(eb, device=dev)
    payloads = soft_cat.gather(1, cols.reshape(c, -1)).reshape(c, max_frames, eb)
    return payloads, q.gather(1, t_idx.clamp(min=0)), slot_valid, t_idx
