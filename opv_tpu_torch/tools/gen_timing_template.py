"""Derive the timing estimator's calibration constant rx/locked.py
_PB_BIAS from the port's own dense correlator (counterpart of
tools/gen_timing_template.py).

The dense sync correlation of a clean OPV capture has a fixed shape around
its apex: a 2-sample plateau with an asymmetric skirt, which pulls the
[1,1]-smoothed 3-point parabola of rx/locked.py _fold_est late by a fixed
amount even on a noise-free fold; _fold_est subtracts that bias.  It is
fixed by the air interface, so it is computed once here, from the exact
TX, dense_soft and dense_sync on the chosen device.

    python -m opv_tpu_torch.tools.gen_timing_template [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG


def compute(half: int = 20, nf: int = 9, delay: int = 5000,
            device="cpu", dtype: str = "float32") -> float:
    """Uncorrected smoothed-parabola estimate minus the true plateau
    center on a clean nf-frame fold: the _PB_BIAS value.

    The capture is delayed into the interior (`delay` samples of leading
    silence): a signal starting at sample 0 truncates the correlation's
    left skirt at the capture head, which fakes a large asymmetry that the
    interior shape does not have.

    dtype "float32" runs the correlator on complex64, as the JAX tool
    derived the baked constant; "float64" on complex128.  The parabola's
    curvature is ~2e-3 of the fold's values, so the float32 correlator's
    rounding moves the result by a few 1e-5 between implementations (the
    JAX package's XLA sums, torch's CPU and CUDA sums); float64 gives the
    same value on every device."""
    from opv_tpu_torch.rx.fast import dense_soft, dense_sync
    from opv_tpu_torch.tools.capture import bert_frames, transmit
    dev = torch.device(device)
    spf = CONFIG.samples_per_frame
    iq = transmit(bert_frames(nf, wrap=False), exact=True, device=dev)
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    x = np.zeros(delay + len(s) + 2048,
                 np.complex64 if dtype == "float32" else np.complex128)
    x[delay:delay + len(s)] = s
    soft = dense_soft(torch.from_numpy(x).to(dev)[None],
                      torch.zeros(1, dtype=torch.float32, device=dev))
    raw, _ = dense_sync(soft)
    raw = raw[0].cpu().numpy().astype(np.float64)
    f = len(raw) // spf
    fold = raw[: f * spf].reshape(f, spf).sum(0)
    seg = fold[np.arange(delay - half, delay - half + 2 * half + 3) % spf]

    sm = seg[:-1] + seg[1:]
    pk = int(np.argmax(sm[: 2 * half + 1]))
    rm, r0, rp = sm[pk - 1], sm[pk], sm[pk + 1]
    d = np.clip(0.5 * (rm - rp) / (rm - 2 * r0 + rp), -0.5, 0.5)
    return float(pk + d + 0.5) - (half + 0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gen_timing_template")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    dev = resolve_device(args.device)
    print("# paste into opv_tpu_torch/rx/locked.py:")
    print("_PB_BIAS = %.10f" % compute(device=dev))
    print("# in float64: %.10f" % compute(device=dev, dtype="float64"))
    # cross-depth drift diagnostic
    for nf in (6, 17, 33):
        print("# bias at nf=%-3d: %+.4f" % (nf, compute(nf=nf, device=dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
