"""Pin-the-grid BER decomposition of the port's streaming engine
(counterpart of tools/timing_pin_probe.py).

The same seeded captures (capture.headtohead_wire) run through the causal
LockedStreamDemodulator with its timing state overridden between feeds
once `--pin-after-frames` of air have fed, separating decode quality from
estimator quality:

  free      the production retime loop as shipped,
  batch     the grid pinned each block to the batch deep-fold estimate
            (rx_locked on the whole noisy capture),
  truth     the grid pinned to the clean-capture anchor (rx_locked on the
            noise-free capture: no estimator noise),
  truth_f0  truth timing and freq_offset forced to 0.

If batch/truth recover the batch path's BER, a streaming BER gap is the
retime estimator wobbling the applied grid, not the decode.  The pin writes
the engine's host lock state (p0, frac, refresh, freq_offset against
_abs_base), so no engine code changes.

    python -m opv_tpu_torch.tools.timing_pin_probe [--ebn0 7] [--bf 4]
        [--frames 200] [--seeds 42 43 44 45 46]
        [--modes free batch truth truth_f0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG

MODES = ("free", "batch", "truth", "truth_f0")


def grid_anchor(x: np.ndarray, n_frames: int, dev) -> float:
    """rx_locked's absolute grid, p0 + frac, of a (N,) complex64 capture."""
    from opv_tpu_torch.rx.locked import rx_locked
    out = rx_locked(torch.from_numpy(x).to(dev)[None], n_frames=n_frames)
    return float(out["p0"][0]) + float(out["frac"][0])


def pinned_run(sw: np.ndarray, mode: str, anchor: float, bf: int,
               pin_after: int, dev):
    """The engine over one (1, N) complex64 capture fed bf frames at a
    time, pinned after each feed (except in mode free) once pin_after
    samples have fed and the channel is locked: (tuples, pins), pins
    holding (samples fed, absolute p0 + frac) of every pin."""
    from opv_tpu_torch.stream import LockedStreamDemodulator
    spf = CONFIG.samples_per_frame
    sd = LockedStreamDemodulator(1, block_frames=bf, dtype="float32",
                                 device=dev)
    res, pins, step, fed = [], [], bf * spf, 0
    for off in range(0, sw.shape[1], step):
        res.extend(sd.feed(sw[:, off:off + step]))
        fed += step
        if mode != "free" and fed >= pin_after and sd.locked[0]:
            want = (anchor - sd._abs_base) % spf
            sd.p0[0] = int(np.floor(want))
            sd.frac[0] = want - np.floor(want)
            sd.refresh[:] = False
            if mode == "truth_f0":
                sd.freq_offset[0] = 0.0
            pins.append((fed, sd._abs_base + int(sd.p0[0])
                         + float(sd.frac[0])))
    res.extend(sd.flush())
    return res, pins


def probe(ebn0: float, bf: int, frames: int, seeds, lead: int,
          pin_after_frames: int, modes, dev, progress=None) -> dict:
    """The tool's JSON object: the anchor and, per mode, the mean full and
    steady-tail BER over the seeds."""
    from opv_tpu_torch.tools.ber_headtohead import (seq_stats, stack_frames,
                                                    tail_stats)
    from opv_tpu_torch.tools.capture import (exact_signal, headtohead_wire,
                                             wire_to_complex)
    spf = CONFIG.samples_per_frame
    truth, s, sig_pow = exact_signal(frames, dev)
    # estimator-bias-free anchor: the batch estimate on the noise-free
    # capture (it shares any data-dependent bias with the noisy estimates,
    # so noisy minus clean isolates the noise-induced error)
    clean = np.concatenate([np.zeros(lead, complex), s]).astype(np.complex64)
    anchor_truth = grid_anchor(clean, frames, dev)
    out = {"ebn0_db": ebn0, "bf": bf, "anchor_truth": anchor_truth,
           "device": str(dev), "modes": {}}
    for mode in modes:
        fulls, tails = [], []
        for seed in seeds:
            sw = wire_to_complex(headtohead_wire(s, sig_pow, seed, ebn0, lead)
                                 ).astype(np.complex64)[None, :]
            anchor = (grid_anchor(sw[0], frames, dev) if mode == "batch"
                      else anchor_truth)
            res, _ = pinned_run(sw, mode, anchor, bf, pin_after_frames * spf,
                                dev)
            st = stack_frames([r[1] for r in res])
            be, _ = seq_stats(st, truth)
            fulls.append(be / (truth.size * 8))
            tails.append(tail_stats(st, truth, skip=frames // 2)[0])
        out["modes"][mode] = {"ber": float(np.mean(fulls)),
                              "ber_steady_tail": float(np.mean(tails)),
                              "tail_per_seed": [round(t, 6) for t in tails]}
        if progress:
            progress(f"{mode:9s} full={np.mean(fulls):.4e} "
                     f"tail={np.mean(tails):.4e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="timing_pin_probe")
    ap.add_argument("--ebn0", type=float, default=7.0)
    ap.add_argument("--bf", type=int, default=4)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46])
    ap.add_argument("--lead", type=int, default=2000)
    ap.add_argument("--pin-after-frames", type=int, default=60,
                    help="start pinning once this much air time has fed "
                         "(lets acquisition run normally)")
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    dev = resolve_device(args.device)
    out = probe(args.ebn0, args.bf, args.frames, args.seeds, args.lead,
                args.pin_after_frames, args.modes, dev,
                progress=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
