"""Whole-capture RX pipelines gluing the tracking demodulator's stages
together (counterpart of opv_tpu/rx/pipeline.py, batched over a leading
channel axis).

`rx_batch` mirrors the reference's batch mode (opv-demod.cpp:1127-1216):
one CFO estimate, one demodulate pass over the whole capture, sync scan,
frame decode.  Each block runs the track_symbols kernel (or, with
coherent=True, the Costas loop of rx/coherent.py in plain torch), the
sync_scan kernel with the sync correlation as its input stage, the payload
gather (torch) and the Viterbi kernel on the block's device, with no host
round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.cfo import estimate_cfo
from opv_tpu_torch.rx.coherent import (coherent_state_init,
                                       demodulate_coherent, pll_gains)
from opv_tpu_torch.rx.demod import (LoopState, complex_dtype,
                                    demodulate_block, loop_state_init,
                                    max_symbols, real_dtype)
from opv_tpu_torch.rx.frame_decoder import decode_payloads
from opv_tpu_torch.rx.sync import (SyncTrackerState, extract_payload_windows,
                                   sync_correlate_scan, sync_tracker_init)


def rx_block_from_soft(soft: torch.Tensor, sym_valid: torch.Tensor,
                       tstate: SyncTrackerState, hist: torch.Tensor,
                       max_frames: int, with_events: bool = False):
    """Sync + decode from a demodulated soft block: soft/sym_valid (C, S),
    hist (C, 2144) soft history from the previous block (zeros at stream
    start).  Returns (out dict of (C, ...) tensors, new tstate, new hist)."""
    eb = CONFIG.encoded_bits
    c = soft.shape[0]
    v = sym_valid.sum(-1)
    soft_cat = torch.cat([hist, soft], -1)
    tstate2, raw, norm, ready, q, events, ev_misses, ev_frames = \
        sync_correlate_scan(tstate,
                            soft_cat[:, eb - (CONFIG.sync_bits - 1):],
                            sym_valid)
    payloads, qs, slot_valid, t_idx = extract_payload_windows(
        soft_cat, ready, q, max_frames)
    frames, metrics, ok = decode_payloads(payloads.reshape(-1, eb))
    hist2 = soft_cat.gather(1, v[:, None] + torch.arange(eb, device=soft.device))
    out = dict(
        frames=frames.reshape(c, max_frames, -1),
        metrics=metrics.reshape(c, max_frames),
        frame_valid=ok.reshape(c, max_frames) & slot_valid,
        sync_q=qs, t_idx=t_idx, n_symbols=v.to(torch.int32),
        soft=soft, sym_valid=sym_valid,
    )
    if with_events:
        out.update(events=events, ev_misses=ev_misses, ev_frames=ev_frames,
                   sync_raw=raw, sync_norm=norm)
    return out, tstate2, hist2


def rx_block(samples: torch.Tensor, n_valid, lstate: LoopState,
             tstate: SyncTrackerState, hist: torch.Tensor, max_frames: int,
             afc_alpha=None, with_events: bool = False):
    """Demod + sync + decode one fixed-capacity block of IQ per channel
    ((C, CAP) complex128, or complex64 for the float32 loop; (C,)
    n_valid).  Returns (out dict, lstate, tstate, hist);
    out["samples_used"] is (C,) int32.  with_events adds
    the per-symbol sync-lifecycle streams (events, ev_misses, ev_frames,
    sync_raw, sync_norm) for the reference's transition diagnostics
    (src/opv-demod.cpp:651-706)."""
    soft, sym_valid, lstate2, used = demodulate_block(
        samples, n_valid, lstate, afc_alpha=afc_alpha)
    out, tstate2, hist2 = rx_block_from_soft(
        soft, sym_valid, tstate, hist, max_frames, with_events=with_events)
    out["samples_used"] = used
    return out, lstate2, tstate2, hist2


def rx_batch(samples, init_offset: float | None = None,
             afc_alpha: float = CONFIG.afc_alpha, dtype: str = "float64",
             coherent: bool = False, pll_bw: float = 50.0, device="cuda"):
    """Batch-demodulate a whole capture (the reference's batch mode).

    samples: (N,) complex (numpy or tensor).  If init_offset is None the
    coarse CFO grid search runs first (opv-demod.cpp:1166).  coherent=True
    runs the Costas-loop demodulator (rx/coherent.py, loop bandwidth pll_bw
    Hz; it decodes nothing in the reference either) in place of the
    tracking loop.  dtype: "float64" (the reference's precision) or
    "float32" (the samples as complex64, every stage in float32, as
    opv_tpu's float32 mode).  Runs on `device` ("cuda" by default; "cpu"
    runs the plain twins).  Returns opv_tpu's result dict as numpy, with
    only the valid frame slots kept in frames/metrics/sync_q/t_idx.
    """
    real = real_dtype(dtype)
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(samples) if not torch.is_tensor(samples)
                        else samples).to(dev, complex_dtype(real))
    n = x.shape[0]
    if init_offset is None:
        offset = estimate_cfo(x).reshape(1).to(real)
    else:
        offset = torch.full((1,), float(init_offset), dtype=real, device=dev)
    tstate = sync_tracker_init(channels=1, device=dev, dtype=real)
    hist = torch.zeros((1, CONFIG.encoded_bits), dtype=real, device=dev)
    if coherent:
        soft, cstate = demodulate_coherent(
            x, coherent_state_init(offset[0], dtype=real, device=dev),
            afc_alpha, *pll_gains(pll_bw))
        max_frames = max_symbols(n) // CONFIG.frame_symbols + 2
        out, tstate2, _ = rx_block_from_soft(
            soft[None], torch.ones((1, soft.shape[0]), dtype=torch.bool,
                                   device=dev),
            tstate, hist, max_frames)
        out["samples_used"] = torch.tensor([n], dtype=torch.int32)
        freq_offset = cstate.freq_offset
    else:
        # the demodulator's 64-sample window needs a buffer at least that
        # long
        buf = x if n >= 64 else torch.cat([x, x.new_zeros(64 - n)])
        max_frames = max_symbols(buf.shape[0]) // CONFIG.frame_symbols + 2
        lstate = loop_state_init(offset, channels=1, device=dev, dtype=real)
        out, lstate2, tstate2, _ = rx_block(
            buf[None], torch.tensor([n], dtype=torch.int32, device=dev),
            lstate, tstate, hist, max_frames, afc_alpha=afc_alpha)
        freq_offset = lstate2.freq_offset[0]
    out = {k: v[0].cpu().numpy() for k, v in out.items()}
    out["freq_offset"] = freq_offset.cpu().numpy()
    out["est_offset"] = offset[0].cpu().numpy()
    out["tracker_state"] = tstate2.state[0].cpu().numpy()
    keep = out["frame_valid"]
    for k in ("frames", "metrics", "sync_q", "t_idx"):
        out[k] = out[k][keep]
    out["decoded"] = int(keep.sum())
    out["perfect"] = int((out["metrics"] == 0).sum())
    return out
