"""Transmitter throughput on the card (counterpart of tools/tx_bench.py),
beside the reference modulator's 10.7 Msamples/s on one Xeon core
(opv-mod, src/opv-mod.cpp:262-280; BASELINE.md):

  modulate   modulate_bits_wire batched over the channels (torch.func.vmap,
             as the JAX tool vmaps it): symbol bits -> int16 IQ wire words,
             C channels x F frames; bound by the 4 B written a sample
  tx_chain   encode_frame + frame_to_symbol_bits + modulate from the
             134-byte payloads (tools/tx_bench.py:101-108)
  exact      modulate_bits_exact on one channel's F frames (the phase_track
             kernel, then float64 sin/cos and the mix): ms per 40 ms frame
             on the host clock, as chip_smoke.py's "exact TX per frame"

modulate and tx_chain are timed by CUDA events around 10 calls a window
(not queued behind a sleep: the modulator makes its state's scalars into
device tensors, a copy that waits on the device), each the median of 5
windows with its min and max; the output (C x F x 86,720 x 4 B) is far
beyond L2.  Checks (a failed one exits 1): the batched rows of the first
and last channel equal the unbatched modulator's; tx_chain's output
equals modulate's; channel 0's fast and exact IQ both decode (rx_locked)
to its F frames with metric 0.

    python -m opv_tpu_torch.tools.tx_bench [--channels 64] [--frames 20]
        [--json FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

#: the reference modulator's rate, Msamples/s (tools/tx_bench.py:2-4)
BASELINE_MSPS = 10.7
SPF = 86_720
#: float32 operations a fast sample (two differences, two products by the
#: sin/cos row and two by the amplitude) and float64 ones an exact sample
#: (each tone's phase add and two wrap compares, four sin/cos at 20 each,
#: the mix and the scale)
FAST_OPS_PER_SAMPLE = 6
EXACT_OPS_PER_SAMPLE = 2 * 3 + 4 * 20 + 8
CALLS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench(c: int, f: int, dev) -> dict:
    from opv_tpu_torch.core.framing import (build_bert_frame, encode_frame,
                                            frame_to_symbol_bits)
    from opv_tpu_torch.rx.locked import rx_locked
    from opv_tpu_torch.tools import timing
    from opv_tpu_torch.tx.modulator import (iq_int16_to_complex, mod_reset,
                                            modulate_bits_exact,
                                            modulate_bits_wire, tx_flush_zeros)
    payloads = np.stack([build_bert_frame("W5NYV", frame_num=np.arange(f)
                                          + 97 * ch) for ch in range(c)])
    payloads_d = torch.from_numpy(payloads).to(dev)         # (C, F, 134)
    st0 = mod_reset()

    def symbol_bits(p):
        return frame_to_symbol_bits(encode_frame(p)).reshape(c, -1).to(
            torch.int32)

    mod_b = torch.func.vmap(lambda b: modulate_bits_wire(b, st0)[0])

    def chain(p):
        return mod_b(symbol_bits(p))

    bits = symbol_bits(payloads_d)                           # (C, F*2168)
    n_out = c * f * SPF
    log(f"geometry: {c} ch x {f} frames = {n_out / 1e6:.1f} M output "
        f"samples ({n_out * 4 / 1e6:.0f} MB int16 IQ) on {dev}")
    failures = []
    wire = mod_b(bits)
    for ch in sorted({0, c - 1}):
        if not torch.equal(wire[ch], modulate_bits_wire(bits[ch], st0)[0]):
            failures.append(f"batched modulate channel {ch} differs from "
                            "the unbatched modulator")
    if not torch.equal(chain(payloads_d), wire):
        failures.append("tx_chain output differs from modulate's")
    exact_iq, _ = modulate_bits_exact(bits[0], st0)
    fast_iq = wire[0].view(torch.int16).reshape(-1, 2)
    flush = tx_flush_zeros(device=dev)
    x = torch.stack([iq_int16_to_complex(torch.cat([iq, flush]))
                     for iq in (fast_iq, exact_iq)])
    out = rx_locked(x, n_frames=f)
    want = torch.from_numpy(payloads[0]).to(dev)
    for i, path in enumerate(("fast", "exact")):
        if not (bool(out["frame_valid"][i].all())
                and int(out["metrics"][i].abs().sum()) == 0
                and torch.equal(out["frames"][i], want)):
            failures.append(f"channel 0's {path} IQ does not decode to its "
                            f"{f} frames with metric 0")
    del wire, exact_iq, x, out

    f32 = timing.PEAK_OPS_PER_S["f32"]
    stages = {}
    t = timing.timed(lambda: mod_b(bits), dev, CALLS)
    stages["modulate"] = dict(
        timing=t, msamples_s=timing.rate(n_out, t),
        roofline=timing.roofline(n_out * 4 + bits.numel() * 4,
                                 [(FAST_OPS_PER_SAMPLE * n_out, f32)], t))
    t = timing.timed(lambda: chain(payloads_d), dev, CALLS)
    stages["tx_chain"] = dict(
        timing=t, msamples_s=timing.rate(n_out, t),
        roofline=timing.roofline(n_out * 4 + payloads.size,
                                 [(FAST_OPS_PER_SAMPLE * n_out, f32)], t))
    t = timing.timed(lambda: modulate_bits_exact(bits[0], st0), dev,
                     clock="host")
    per_frame = ({k: t[f"{k}_ms"] / f for k in ("median", "min", "max")}
                 if "median_ms" in t else timing.NOT_MEASURED)
    stages["exact"] = dict(
        timing=t, frames_per_call=f, ms_per_frame=per_frame,
        roofline=timing.roofline(f * SPF * 4 + bits[0].numel() * 4,
                                 [(EXACT_OPS_PER_SAMPLE * f * SPF,
                                   timing.PEAK_OPS_PER_S["f64"])], t))
    msps = stages["modulate"]["msamples_s"]
    for name, st in stages.items():
        log(f"{name}: {st['timing']}")
    return dict(channels=c, frames_per_chan=f, out_samples=n_out,
                stages=stages, modulate_msps=msps,
                modulate_vs_baseline=(
                    {k: v / BASELINE_MSPS for k, v in msps.items()}
                    if isinstance(msps, dict) else timing.NOT_MEASURED),
                tx_chain_msps=stages["tx_chain"]["msamples_s"],
                baseline_msps=BASELINE_MSPS,
                checks=dict(passed=not failures, failures=failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tx_bench")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    from opv_tpu_torch.tools.timing import header
    dev = resolve_device(args.device)
    out = header("tx_bench", argv if argv is not None else sys.argv[1:],
                 dev, args.commit)
    out.update(bench(args.channels, args.frames, dev))
    txt = json.dumps(out)
    if args.json:
        pathlib.Path(args.json).write_text(txt + "\n")
    print(txt)
    for line in out["checks"]["failures"]:
        log(f"check failed: {line}")
    return 0 if out["checks"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
