"""Streaming demodulator: chunked processing with state carryover
(counterpart of opv_tpu/stream/chunked.py; the reference's streaming mode,
opv-demod.cpp:995-1125).

IQ arrives incrementally; whenever one frame's worth of samples (86,720)
is buffered, a chunk is processed; the unconsumed tail samples (timing
continuity) stay at the head of the next chunk; the first chunk triggers
the coarse CFO estimate; a final partial chunk is flushed at EOF.  The
buffer is host memory, as in opv_tpu; each chunk is copied to the device,
runs rx_block there (the track_symbols, sync_scan and Viterbi kernels on a
card), and its results are copied back to the host once it is done.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.cfo import estimate_cfo
from opv_tpu_torch.rx.demod import (LoopState, loop_state_init, max_symbols,
                                    real_dtype)
from opv_tpu_torch.rx.pipeline import rx_block
from opv_tpu_torch.rx.sync import SyncTrackerState, sync_tracker_init

STATE_NAMES = ("HUNTING", "VERIFYING", "LOCKED")


def fetch(out: dict, keys) -> dict:
    """The named result tensors as numpy (the first copy waits for the
    chunk's work on the device)."""
    return {k: out[k].cpu().numpy() for k in keys}


class StreamingDemodulator:
    """Incremental sample stream -> decoded frame stream."""

    def __init__(self, init_offset: float | None = None,
                 afc_alpha: float = CONFIG.afc_alpha, dtype: str = "float64",
                 chunk_samples: int | None = None, on_event=None,
                 device="cuda"):
        """on_event(sym_idx, code, norm, raw, misses, frames): optional
        callback fired per sync-lifecycle transition (rx.sync.EV_* codes),
        the reference's stderr diagnostics (src/opv-demod.cpp:651-706).
        device: where the chunks run ("cuda" by default; "cpu" runs the
        plain twins).  dtype: "float64" (the reference's precision) or
        "float32" (a complex64 buffer and every stage in float32, as
        opv_tpu's float32 mode)."""
        self.real = real_dtype(dtype)
        self.device = torch.device(device)
        self.chunk = chunk_samples or CONFIG.chunk_samples
        self.cap = self.chunk          # the buffer is always <= one chunk
        self.afc_alpha = float(afc_alpha)
        self.max_frames = max_symbols(self.cap) // CONFIG.frame_symbols + 2
        self.on_event = on_event

        self._cdtype = np.complex128 if dtype == "float64" else np.complex64
        self._buf = np.zeros(self.cap, dtype=self._cdtype)
        self._count = 0
        self._first = True
        self._init_offset = init_offset

        dev = self.device
        self._lstate = loop_state_init(0.0, channels=1, device=dev,
                                       dtype=self.real)
        self._tstate = sync_tracker_init(channels=1, device=dev,
                                         dtype=self.real)
        self._hist = torch.zeros((1, CONFIG.encoded_bits), dtype=self.real,
                                 device=dev)

        self.total_samples = 0
        self.total_symbols = 0
        self.decoded = 0
        self.perfect = 0
        self.est_offset = None

    # -- public API ---------------------------------------------------------

    def feed(self, samples):
        """Feed complex samples (numpy or tensor); returns (frame_bytes,
        metric, sync_q, sym_idx) for every decoded frame."""
        if torch.is_tensor(samples):
            samples = samples.cpu().numpy()
        samples = np.asarray(samples, dtype=self._cdtype).reshape(-1)
        off = 0
        results = []
        while off < len(samples):
            take = min(self.chunk - self._count, len(samples) - off)
            self._buf[self._count:self._count + take] = samples[off:off + take]
            self._count += take
            off += take
            if self._count >= self.chunk:
                results.extend(self._process(self._count))
        return results

    def flush(self):
        """Process any buffered tail (EOF), like opv-demod.cpp:1088-1113."""
        if self._count > 0:
            return self._process(self._count)
        return []

    @property
    def lstate(self) -> LoopState:
        """The loop carry, 0-d tensors (opv_tpu's layout)."""
        return LoopState(*(x[0] for x in self._lstate))

    @property
    def tstate(self) -> SyncTrackerState:
        return SyncTrackerState(*(x[0] for x in self._tstate))

    @property
    def hist(self) -> torch.Tensor:
        return self._hist[0]

    def state_tree(self):
        """Complete serializable state in opv_tpu's layout: the device
        carries and the host-side seam record (buffered raw samples,
        first-chunk flag, counters); a restore()d demodulator continues bit
        for bit, in either package."""
        return dict(
            lstate=LoopState(*(x.cpu() for x in self.lstate)),
            tstate=SyncTrackerState(*(x.cpu() for x in self.tstate)),
            hist=self.hist.cpu(),
            buf=self._buf[:self._count].copy(),
            first=np.bool_(self._first),
            est_offset=np.float64(self.est_offset if self.est_offset
                                  is not None else np.nan),
            counters=np.array([self.total_samples, self.total_symbols,
                               self.decoded, self.perfect], dtype=np.int64),
        )

    def restore(self, tree) -> None:
        """Adopt a state produced by state_tree() (e.g. via load_state), of
        this package or of opv_tpu."""
        dev = self.device

        def leaves(node, like):
            return type(like)(*(torch.as_tensor(np.asarray(x)).to(dev)
                                .reshape(1).to(y.dtype)
                                for x, y in zip(node, like)))

        self._lstate = leaves(tree["lstate"], self._lstate)
        self._tstate = leaves(tree["tstate"], self._tstate)
        self._hist = torch.as_tensor(np.asarray(tree["hist"])).to(
            dev, self.real).reshape(1, -1)
        buf = np.asarray(tree["buf"])
        self._buf[:len(buf)] = buf
        self._count = len(buf)
        self._first = bool(tree["first"])
        eo = float(tree["est_offset"])
        self.est_offset = None if np.isnan(eo) else eo
        (self.total_samples, self.total_symbols,
         self.decoded, self.perfect) = (int(x) for x in tree["counters"])

    # -- internals ----------------------------------------------------------

    def _process(self, n_valid: int):
        dev = self.device
        x = torch.from_numpy(self._buf).to(dev)
        if self._first:
            if self._init_offset is None:
                # the reference estimates on the full first chunk
                est = float(estimate_cfo(x))
            else:
                est = float(self._init_offset)
            self.est_offset = est
            self._lstate = self._lstate._replace(freq_offset=torch.full(
                (1,), est, dtype=self.real, device=dev))
            self._first = False

        ev = self.on_event is not None
        out, self._lstate, self._tstate, self._hist = rx_block(
            x[None], torch.tensor([n_valid], dtype=torch.int32),
            self._lstate, self._tstate, self._hist, self.max_frames,
            afc_alpha=self.afc_alpha, with_events=ev)
        keys = ["samples_used", "n_symbols", "frames", "metrics",
                "frame_valid", "sync_q", "t_idx"]
        if ev:
            keys += ["events", "ev_misses", "ev_frames", "sync_norm",
                     "sync_raw"]
        r = {k: v[0] for k, v in fetch(out, keys).items()}
        used = int(r["samples_used"])
        nsym = int(r["n_symbols"])
        # NB: deliberately counts the carried-over leftover samples again,
        # as the reference does (total_samples += chunk_buf.size(),
        # opv-demod.cpp:1027); the status line's seconds derive from it
        self.total_samples += n_valid
        base_sym = self.total_symbols
        self.total_symbols += nsym

        if ev:
            for t in np.flatnonzero(r["events"]):
                self.on_event(base_sym + int(t), int(r["events"][t]),
                              float(r["sync_norm"][t]), float(r["sync_raw"][t]),
                              int(r["ev_misses"][t]), int(r["ev_frames"][t]))

        results = []
        t_idx = r["t_idx"]
        for i in np.argsort(t_idx, kind="stable"):
            if r["frame_valid"][i]:
                metric = int(r["metrics"][i])
                self.decoded += 1
                if metric == 0:
                    self.perfect += 1
                results.append((bytes(r["frames"][i]), metric,
                                float(r["sync_q"][i]), base_sym + int(t_idx[i])))

        # keep the unconsumed tail for timing continuity
        # (opv-demod.cpp:1069-1077)
        leftover = n_valid - used
        if 0 < leftover < n_valid:
            self._buf[:leftover] = self._buf[used:n_valid]
            self._count = leftover
        else:
            self._count = 0
        return results

    @property
    def freq_offset(self) -> float:
        return float(self._lstate.freq_offset[0])

    @property
    def timing_freq(self) -> float:
        return float(self._lstate.timing_freq[0])

    @property
    def sync_state(self) -> str:
        return STATE_NAMES[int(self._tstate.state[0])]
