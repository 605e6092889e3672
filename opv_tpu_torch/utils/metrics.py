"""Structured metrics: one JSON line per snapshot, machine-parsable by
deployment tooling (counterpart of opv_tpu/utils/metrics.py, with the same
keys)."""

from __future__ import annotations

import json
import sys
import time

from opv_tpu_torch.config import CONFIG


def demod_metrics(sd) -> dict:
    """Snapshot a StreamingDemodulator's state as a flat dict."""
    return {
        "ts": time.time(),
        "samples": sd.total_samples,
        "seconds": sd.total_samples / CONFIG.sample_rate,
        "symbols": sd.total_symbols,
        "frames": sd.decoded,
        "perfect": sd.perfect,
        "errors": sd.decoded - sd.perfect,
        "sync_state": sd.sync_state,
        "afc_hz": sd.freq_offset,
        "timing_ppm": sd.timing_freq * 1e6,
        "est_offset_hz": sd.est_offset,
    }


def locked_metrics(mc, channels: int | None = None,
                   n_samples: int | None = None) -> dict:
    """Snapshot a LockedStreamDemodulator as a flat dict, with the
    per-block device-wait vs host-lifecycle split when the engine was
    built with timing=True."""
    m = {"ts": time.time(), "engine": "locked"}
    if channels:
        m["channels"] = channels
    if n_samples is not None and channels:
        m["samples_per_chan"] = n_samples // channels
        m["seconds"] = n_samples / channels / CONFIG.sample_rate
    m.update(mc.stats())
    if mc.block_stats:
        m["last_block"] = mc.block_stats[-1]
    m["locked_channels"] = int(mc.locked.sum())
    return m


def emit_json(metrics: dict, out=None) -> None:
    print(json.dumps(metrics, default=float), file=out or sys.stderr,
          flush=True)



class MetricHistogram:
    """Tiny fixed-bucket histogram (e.g. Viterbi path metrics)."""

    def __init__(self, edges=(0, 1, 10, 100, 500, 1000, 5000)):
        self.edges = list(edges)
        self.counts = [0] * (len(self.edges) + 1)

    def add(self, v: float) -> None:
        for i, e in enumerate(self.edges):
            if v <= e:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def as_dict(self) -> dict:
        labels = [f"<={e}" for e in self.edges] + [f">{self.edges[-1]}"]
        return dict(zip(labels, self.counts))
