"""Does a channel's result depend on how many channels share the call?
Each device program of the locked engine and the dense receiver runs once
over the whole bank and once per shard of channels, on one GPU, and the
shards' results are held against the bank's, bit for bit.

    python scripts/batch_probe.py [--shards 8,1] [--out build/batch_probe.json]

The inputs are chip_smoke.py's stream-64 feed (64 channels, the gap-burst
channels 56-63) cut to one engine window at block 4, the state rx_locked
acquires on the main path's stream, a mixed keep mask (every third
channel hunting) and per-channel int8 steps; channelize_cols runs on one
K = 64 quantum of seeded noise.  Two arms: the port as it is (the CFO grid
and refinement sum in float64 on the card, rx/cfo.py::needs_wide_sums),
and the same with those sums in float32 (needs_wide_sums off).  Prints,
per arm, program, output and shard size, "equal" or the count and size of
the differences, then one JSON line; --out writes the JSON too.  Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def differences(full, parts) -> dict:
    """{output name: None (equal) or (count, max |diff|, max |full|)}."""
    import torch
    if isinstance(full, dict):
        out = {}
        for k in full:
            if k != "n_decoded":
                out.update({f"{k}{n}": v for n, v in differences(
                    full[k], [p[k] for p in parts]).items()})
        return out
    if isinstance(full, tuple):
        out = {}
        for i, f in enumerate(full):
            out.update({f"[{i}]{n}": v for n, v in differences(
                f, [p[i] for p in parts]).items()})
        return out
    cat = torch.cat([p.to(full.device) for p in parts])
    a, b = full, cat
    if a.dtype.is_complex:
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if torch.equal(a, b):
        return {"": None}
    d = (a.double() - b.double()).abs()
    return {"": (int((a != b).sum()), float(d.max()),
                 float(a.double().abs().max()))}


def programs(dev):
    """{name: fn(channel slice) -> outputs} on the stream-64 window."""
    import torch
    import chip_smoke as cs
    from opv_tpu_torch.rx import locked as lk
    from opv_tpu_torch.rx.cfo import estimate_cfo_batch
    from opv_tpu_torch.rx.channelizer import _on_device, channelize_cols
    from opv_tpu_torch.rx.fast import dense_soft, rx_fast
    x, frames, delays = cs.synthesize(dev)
    feed, _ = cs.stream_feed(x, frames, delays, dev)
    c, bf = feed.shape[0], cs.STREAM_BF
    win = (bf + 1) * cs.SPF + 1040
    xw = feed[:, 4 * cs.SPF: 4 * cs.SPF + win].contiguous()
    acq = lk.rx_locked(x[:, : 3 * cs.SPF], n_frames=1)
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]
    keep = torch.ones(c, dtype=torch.bool, device=dev)
    keep[::3] = False
    rows_f = lk.to_window_rows(xw, torch.float32)
    rows_q = lk.to_window_rows(xw, torch.int8)
    scale = torch.linspace(100, 140, c, device=dev)
    g = torch.Generator().manual_seed(3)
    k, n_wb = 64, 64 * (12 + bf * cs.SPF // 8)
    wb = (torch.complex(torch.randn(n_wb, generator=g),
                        torch.randn(n_wb, generator=g)) * 1000).to(dev)
    kern = _on_device("dft", k, 12, torch.device(dev), torch.float32)
    return {
        "estimate_cfo_batch": lambda s: estimate_cfo_batch(xw[s]),
        "refine_cfo_locked": lambda s: lk.refine_cfo_locked(
            xw[s], p0[s], foff[s]),
        "dense_soft": lambda s: dense_soft(xw[s], foff[s]),
        "steady float32": lambda s: lk.rx_locked_steady(
            rows_f[s], p0[s], foff[s], bf, frac=frac[s]),
        "steady int8": lambda s: lk.rx_locked_steady(
            rows_q[s], p0[s], foff[s], bf, scale=scale[s], frac=frac[s]),
        "reacquire": lambda s: lk.rx_locked_reacquire(
            xw[s], p0[s], foff[s], keep[s], bf, frac_old=frac[s]),
        "reacquire stride 2": lambda s: lk.rx_locked_reacquire_strided(
            xw[s], p0[s], foff[s], keep[s], bf, frac[s], 2),
        "retime": lambda s: lk.rx_locked_retime(xw[s], p0[s], foff[s],
                                                n_frames=bf),
        "rx_fast": lambda s: rx_fast(xw[s], max_frames=8),
        "channelize_cols": lambda s: channelize_cols(wb, kern[:, s], k),
    }


def probe(dev, shards, arm: str) -> dict:
    """{program: {shard size: {output: difference}}} in one arm."""
    from opv_tpu_torch.rx import cfo, locked
    wide = arm == "float64 sums"
    saved = cfo.needs_wide_sums
    cfo.needs_wide_sums = locked.needs_wide_sums = (
        saved if wide else (lambda t: False))
    try:
        res = {}
        for name, fn in programs(dev).items():
            full = fn(slice(None))
            total = 64
            res[name] = {}
            for n in shards:
                parts = [fn(slice(i, i + n)) for i in range(0, total, n)]
                res[name][n] = differences(full, parts)
                for out, d in res[name][n].items():
                    what = "equal" if d is None else (
                        f"DIFFER {d[0]} values, max |diff| {d[1]:.4g} of "
                        f"{d[2]:.4g}")
                    print(f"[{arm}] {name}{out} shards of {n}: {what}",
                          flush=True)
        return res
    finally:
        cfo.needs_wide_sums = locked.needs_wide_sums = saved


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", default="8,1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("batch_probe: no CUDA device")
    from opv_tpu_torch.ops import build
    import chip_smoke as cs
    build.library()
    card = cs.nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    shards = [int(v) for v in args.shards.split(",")]
    res = {arm: probe(dev, shards, arm)
           for arm in ("float64 sums", "float32 sums")}
    line = json.dumps({"card": card, "arms": res})
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
