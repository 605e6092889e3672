"""Structured metrics: one JSON line per snapshot, machine-parsable by
deployment tooling (counterpart of opv_tpu/utils/metrics.py, with the same
keys)."""

from __future__ import annotations

import json
import sys
import time

from opv_tpu_torch.config import CONFIG


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

