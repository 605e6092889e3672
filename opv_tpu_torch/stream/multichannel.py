"""Multichannel streaming through the feed-forward dense receiver
(counterpart of opv_tpu/stream/multichannel.py): C concurrent channels in
fixed-size overlapped blocks.

Overlap-save: every block sees `block_frames` frames of new samples plus
one frame and a sync word of overlap, so a frame straddling a block
boundary is decoded exactly once (a frame belongs to the block in which
its sync word starts).  All channels advance in lockstep, so a block is one
rx_fast call over every channel (the CFO grid re-estimated per block, one
Viterbi launch over every (channel, slot) payload).

The (C, window) complex64 window lives on the device; a feed given as a
tensor there goes in without a host round trip.  A block's results come
back in one transfer: starts, validity, metrics, sync quality and frame
bytes packed into one uint8 tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.fast import rx_fast
from opv_tpu_torch.stream.state import to_device

_FB = CONFIG.frame_bytes
_SYNC_OFF = CONFIG.sync_bits * CONFIG.samples_per_symbol
_PAYLOAD_EXTENT = (CONFIG.encoded_bits - 1) * CONFIG.samples_per_symbol + 1


def _pack(out: dict) -> torch.Tensor:
    """A block's (C, F) results as one (C, F, 134 + 13) uint8 tensor:
    frame bytes, then the little-endian bytes of start (int32), metric
    (int32) and sync_q (float32), then frame_valid."""
    cols = [out["frames"]]
    for k, dt in (("starts", torch.int32), ("metrics", torch.int32),
                  ("sync_q", torch.float32)):
        cols.append(out[k].to(dt).contiguous()[..., None].view(torch.uint8))
    cols.append(out["frame_valid"].to(torch.uint8)[..., None])
    return torch.cat(cols, -1)


def _unpack(packed: np.ndarray):
    """(frames, starts, metrics, sync_q, valid) of a _pack as numpy."""
    f = packed[..., :_FB]

    def word(i, dt):
        return np.ascontiguousarray(
            packed[..., _FB + 4 * i: _FB + 4 * i + 4]).view(dt)[..., 0]
    return (f, word(0, "<i4"), word(1, "<i4"), word(2, "<f4"),
            packed[..., _FB + 12] != 0)


class MultiChannelDemodulator:
    """Feed (C, n) sample blocks; yields (channel, frame_bytes, metric,
    sync_quality, abs_sample_pos) tuples."""

    def __init__(self, channels: int, block_frames: int = 4,
                 max_frames_per_block: int | None = None, device="cuda"):
        """device: where the window lives and every block runs ("cuda" by
        default, which raises without a card; "cpu" runs the plain
        twins)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MultiChannelDemodulator(device='cuda') needs a CUDA device; "
                "pass device='cpu' to run the plain twins on the host")
        self.channels = channels
        self.spf = CONFIG.samples_per_frame
        self.advance = block_frames * self.spf
        # overlap: one frame + sync, so a frame whose sync starts in the
        # advance region lies wholly in the window
        self.overlap = self.spf + _SYNC_OFF
        self.window = self.advance + self.overlap
        self.max_frames = max_frames_per_block or (block_frames + 2)

        self._buf = torch.zeros((channels, self.window), dtype=torch.complex64,
                                device=self.device)
        self._count = 0                 # valid samples in the window
        self._abs_base = 0              # absolute index of window sample 0
        self.decoded = 0
        self.perfect = 0

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """x on the window's device (stream/state.py::to_device)."""
        return to_device(x, self.device)

    def feed(self, samples):
        """samples: (C, n) complex, numpy or tensor, cast to complex64.
        Returns decoded-frame tuples."""
        x = (samples if isinstance(samples, torch.Tensor)
             else torch.from_numpy(np.asarray(samples)))
        if x.dim() != 2 or x.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got "
                             f"{tuple(x.shape)}")
        x = self._to_device(x.to(torch.complex64))
        out = []
        off = 0
        n = x.shape[1]
        while off < n:
            take = min(self.window - self._count, n - off)
            self._buf[:, self._count:self._count + take] = x[:, off:off + take]
            self._count += take
            off += take
            if self._count >= self.window:
                out.extend(self._process())
        return out

    def flush(self):
        """Process the remaining tail (zero padded)."""
        if self._count <= self.overlap // 2:
            return []
        self._buf[:, self._count:] = 0
        # ownership over the whole remaining valid region, but no frame
        # whose payload reaches into the padding (a stream cut mid-frame
        # must not yield a corrupted phantom frame)
        results = self._process(own_limit=self._count,
                                valid_limit=self._count)
        self._count = 0
        return results

    def _process(self, own_limit: int | None = None,
                 valid_limit: int | None = None):
        own = self.advance if own_limit is None else own_limit
        vlim = self.window if valid_limit is None else valid_limit
        out = rx_fast(self._buf, max_frames=self.max_frames)
        frames, starts, metrics, qs, valid = _unpack(_pack(out).cpu().numpy())
        results = []
        for c in range(self.channels):
            for k in np.argsort(starts[c]):
                if not valid[c, k]:
                    continue
                sync_start = int(starts[c, k]) - _SYNC_OFF
                if sync_start >= own:           # owned by the next block
                    continue
                if int(starts[c, k]) + _PAYLOAD_EXTENT > vlim:
                    continue                    # payload reaches the padding
                self.decoded += 1
                if metrics[c, k] == 0:
                    self.perfect += 1
                results.append((c, bytes(frames[c, k]), int(metrics[c, k]),
                                float(qs[c, k]), self._abs_base + sync_start))
        if own_limit is None:
            # slide: keep the overlap tail at the front
            self._buf[:, : self.overlap] = self._buf[:, self.advance:].clone()
            self._count = self.overlap
            self._abs_base += self.advance
        return results
