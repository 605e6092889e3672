"""Multichannel reference-parity streaming: the full tracking demodulator
(AFC + early-late timing + sync flywheel) over C channels at once
(counterpart of opv_tpu/stream/tracking.py).

Every channel runs the complete feedback-loop pipeline, tuple for tuple
the same as C independent StreamingDemodulators, but all channels advance
in one launch of each kernel per chunk (track_symbols with a block per
channel, sync_scan with a warp per channel and the sync correlation as
its input stage, one Viterbi batch).

Per-channel chunk boundaries are kept exactly for equal-rate channels
(each channel processes precisely 86,720-sample chunks whatever its own
leftover), so parity with the single-channel receiver holds channel by
channel.  Channels with persistently divergent sample clocks are handled
without deadlock or data loss by early short chunks (see feed()), at the
cost of exact chunk-boundary parity for the lagging channels.

The (C, 86,720 + 4,096) complex128 (complex64 at dtype="float32") buffer
lives on the device: a feed is
copied there once and written at each channel's count, and a chunk's
leftovers move to the head of each row by a gather; only the per-channel
counts stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.cfo import estimate_cfo_batch
from opv_tpu_torch.rx.demod import (complex_dtype, loop_state_init,
                                    max_symbols, real_dtype)
from opv_tpu_torch.rx.pipeline import rx_block
from opv_tpu_torch.rx.sync import sync_tracker_init
from opv_tpu_torch.stream.chunked import STATE_NAMES, fetch


class MultiChannelTrackingDemodulator:
    """N-channel streaming demod with full per-channel loop tracking."""

    def __init__(self, channels: int, init_offset: float | None = None,
                 afc_alpha: float = CONFIG.afc_alpha, dtype: str = "float64",
                 device="cuda"):
        """init_offset: Hz for every channel, or one value per channel
        (None: the first chunk's CFO estimate).  dtype: "float64" (the
        reference's precision) or "float32" (a complex64 buffer and every
        stage in float32, as opv_tpu's float32 mode)."""
        self.real = real_dtype(dtype)
        self.channels = channels
        self.device = dev = torch.device(device)
        self.chunk = CONFIG.chunk_samples
        # slack beyond one chunk: per-channel leftovers drift apart, and a
        # fuller channel must be able to wait while the emptiest one
        # reaches a full chunk; with persistently divergent sample clocks
        # the spread grows unboundedly, so feed() also processes early when
        # a buffer fills
        self.cap = self.chunk + 4096
        self.afc_alpha = float(afc_alpha)
        self.max_frames = max_symbols(self.cap) // CONFIG.frame_symbols + 2

        self._cplx = complex_dtype(self.real)
        self._buf = torch.zeros((channels, self.cap), dtype=self._cplx,
                                device=dev)
        self._count = np.zeros(channels, dtype=np.int64)
        self._first = True
        self._init_offset = init_offset
        self._cols = torch.arange(self.cap, device=dev)

        self.lstate = loop_state_init(0.0, channels=channels, device=dev,
                                      dtype=self.real)
        self.tstate = sync_tracker_init(channels=channels, device=dev,
                                        dtype=self.real)
        self.hist = torch.zeros((channels, CONFIG.encoded_bits),
                                dtype=self.real, device=dev)

        self.decoded = np.zeros(channels, dtype=np.int64)
        self.perfect = np.zeros(channels, dtype=np.int64)
        self.total_symbols = np.zeros(channels, dtype=np.int64)
        self.est_offset = None

    def feed(self, samples):
        """samples: (C, n) complex, numpy or tensor.  Returns a list of
        (channel, frame_bytes, metric, sync_q, symbol_idx)."""
        x = torch.as_tensor(samples).to(self.device, self._cplx)
        if x.dim() != 2 or x.shape[0] != self.channels:
            raise ValueError(f"expected ({self.channels}, n) samples, got "
                             f"{tuple(x.shape)}")
        out = []
        off = 0
        n = x.shape[1]
        while off < n:
            room = self.cap - self._count
            take = min(int(room.min()), n - off)
            if take > 0:
                self._write(x[:, off:off + take])
                off += take
            if (self._count >= self.chunk).all():
                out.extend(self._process(np.minimum(self._count, self.chunk)))
            elif take <= 0:
                # a channel's buffer is full while another lags (divergent
                # sample clocks): process what each channel has rather than
                # deadlocking.  Lagging channels see a slightly short chunk;
                # per-channel parity with independent receivers holds only
                # for equal-rate channels, but no input is ever dropped.
                out.extend(self._process(np.minimum(self._count, self.chunk)))
        return out

    def flush(self):
        if (self._count > 0).any():
            res = self._process(self._count.copy())
            self._count[:] = 0
            return res
        return []

    def _write(self, x: torch.Tensor) -> None:
        """Append (C, take) samples at each channel's count."""
        take = x.shape[1]
        c0 = int(self._count[0])
        if (self._count == c0).all():
            self._buf[:, c0:c0 + take] = x
        else:
            at = torch.from_numpy(self._count).to(self.device)[:, None] \
                + torch.arange(take, device=self.device)
            self._buf.scatter_(1, at, x)
        self._count += take

    def _process(self, n_valid: np.ndarray):
        dev = self.device
        if self._first:
            if self._init_offset is None:
                est = estimate_cfo_batch(self._buf).cpu().numpy()
            else:
                est = np.broadcast_to(np.asarray(self._init_offset,
                                                 np.float64),
                                      (self.channels,)).copy()
            self.est_offset = est
            self.lstate = self.lstate._replace(
                freq_offset=torch.from_numpy(est).to(dev, self.real))
            self._first = False

        out, self.lstate, self.tstate, self.hist = rx_block(
            self._buf, torch.from_numpy(n_valid.astype(np.int32)),
            self.lstate, self.tstate, self.hist, self.max_frames,
            afc_alpha=self.afc_alpha)
        # leftovers to the head of each row, on the device; what lies past
        # a row's count is never read
        used_d = out["samples_used"].to(torch.int64)
        self._buf = self._buf.gather(
            1, (used_d[:, None] + self._cols).clamp_(max=self.cap - 1))
        r = fetch(out, ("samples_used", "n_symbols", "frames", "metrics",
                        "frame_valid", "sync_q", "t_idx"))
        used, nsym, t_idx = r["samples_used"], r["n_symbols"], r["t_idx"]
        results = []
        for c in range(self.channels):
            base = int(self.total_symbols[c])
            for i in np.argsort(t_idx[c], kind="stable"):
                if r["frame_valid"][c, i]:
                    metric = int(r["metrics"][c, i])
                    self.decoded[c] += 1
                    if metric == 0:
                        self.perfect[c] += 1
                    results.append((c, bytes(r["frames"][c, i]), metric,
                                    float(r["sync_q"][c, i]),
                                    base + int(t_idx[c, i])))
            self.total_symbols[c] += int(nsym[c])
        # keep = leftover (n_valid - used) + the samples past n_valid
        self._count = self._count - used.astype(np.int64)
        return results

    @property
    def freq_offset(self) -> np.ndarray:
        return self.lstate.freq_offset.cpu().numpy()

    @property
    def sync_state(self) -> list:
        return [STATE_NAMES[int(s)] for s in self.tstate.state.cpu()]
