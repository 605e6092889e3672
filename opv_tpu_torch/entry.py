"""Counterpart of __graft_entry__.entry() for the port: the locked-grid
batch receiver as one forward step on a CUDA tensor."""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """-> (step, example_args): step(samples) runs rx_locked(samples,
    n_frames=1, estimate_cfo_flag=True) and returns (frames, metrics,
    frame_valid, n_decoded)."""
    from opv_tpu_torch.rx.locked import rx_locked

    def step(samples):
        out = rx_locked(samples, n_frames=1, estimate_cfo_flag=True)
        return (out["frames"], out["metrics"], out["frame_valid"],
                out["n_decoded"])

    c, n = 1, 178_000
    rng = np.random.default_rng(0)
    example = torch.from_numpy(
        (rng.standard_normal((c, n)) + 1j * rng.standard_normal((c, n))
         ).astype(np.complex64) * 1000.0).to(device)
    return step, (example,)
