"""Scaling of the time-sharded receiver (counterpart of
tools/scaling_bench.py).

  weak scaling  parallel/grid.py::rx_grid_sharded on a ('ch'=1, 'time'=n)
                mesh for each n of --devices, each shard --frames-per-dev
                frames of one fast-TX capture (overlap-save halos from the
                right neighbour): Msamples/s and the efficiency
                msps(n) / (n msps(first)).  The mesh names the device n
                times, so on one card (or the CPU) every shard shares it:
                the rows measure the cost of sharding, not scaling, and
                say so ("one_device")
  --halo-sweep  the mesh fixed at ('ch'=1, 'time'=max(--devices)), the
                shard size swept so the halo is a fraction r of each shard
                (--fractions), CFO estimation on and off; the per-shard
                fit wall/ntime = c_fix + c_lin (shard + halo) and the
                efficiency it projects at r = 0.5, 0.25, 0.10, 0.05
                (tools/scaling_bench.py:27-156)
  --shard-cost  one shard's program alone, rx_fast over shard + halo
                samples of one channel on one device, at each fraction:
                t(n_ext) = c_fix + c_lin n_ext, c_fix clamped at 0 for the
                projection c_lin shard / (c_fix + c_lin (shard + halo))
                (the JAX tool's --tpu-shard-cost, :159-302)

Weak scaling and the halo sweep are timed on the host clock (each call
ends in torch.cuda.synchronize()); a shard's rx_fast by CUDA events; each
the median of 5 windows with its min and max.  Checks (a failed one exits
1): every weak-scaling run decodes its n x frames-per-dev frames, and
every halo-sweep and shard-cost run, byte-exact, each frame that fits
whole in its samples (their capture ends mid-frame, as the JAX tool's).

    python -m opv_tpu_torch.tools.scaling_bench [--devices 1 2 4 8]
        [--frames-per-dev 4] [--halo-sweep] [--shard-cost]
        [--fractions 1 0.5 0.25 0.10 0.05] [--json FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

import numpy as np
import torch

SPF = 86_720
#: the halo fractions the fits project efficiency at
PROJECT_AT = (0.5, 0.25, 0.10, 0.05)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def capture(n_samples: int, dev):
    """((1, n_samples) complex64 on dev: the fast TX of enough BERT frames,
    cut to n_samples; the bytes of the frames that fit whole)."""
    from opv_tpu_torch.tools.capture import fast_stream
    s, frames = fast_stream(n_samples // SPF + 1, dev)
    return (s[:n_samples][None].contiguous(),
            [bytes(f) for f in frames[: n_samples // SPF]])


def transmitted(frames: torch.Tensor, valid: torch.Tensor, sent) -> int:
    """How many of the whole transmitted frames `sent` are among the valid
    frames (C, F, 134), each counted once."""
    got = collections.Counter(bytes(row) for row in
                              frames[valid.bool()].cpu().numpy())
    want = collections.Counter(sent)
    return sum(min(n, got[b]) for b, n in want.items())


def one_device(mesh) -> bool:
    return len({str(d) for d in mesh.devices.reshape(-1)}) == 1


def weak_scaling(counts, fpd: int, dev, failures: list) -> list:
    from opv_tpu_torch.parallel.grid import rx_grid_sharded
    from opv_tpu_torch.parallel.mesh import make_mesh
    from opv_tpu_torch.tools import timing
    from opv_tpu_torch.tools.capture import fast_stream
    rows, base = [], None
    for n in counts:
        s, _ = fast_stream(n * fpd, dev)
        per = -(-s.shape[0] // n)
        block = -(-per // 8) * 8
        samples = torch.zeros((1, n * block), dtype=torch.complex64,
                              device=dev)
        samples[0, : s.shape[0]] = s
        mesh = make_mesh({"ch": 1, "time": n}, devices=[dev] * n)

        def run():
            return rx_grid_sharded(mesh, samples,
                                   max_frames_per_shard=fpd + 2)
        decoded = int(run()["n"])
        if decoded != n * fpd:
            failures.append(f"weak scaling n={n}: {decoded} of {n * fpd} "
                            "frames")
        t = timing.timed(run, dev, clock="host")
        msps = timing.rate(samples.numel(), t)
        if base is None:
            base = msps
        eff = ({k: msps[k] / (base["median"] * n) for k in msps}
               if isinstance(msps, dict) else timing.NOT_MEASURED)
        rows.append(dict(devices=n, samples=samples.numel(), timing=t,
                         msps=msps, efficiency=eff, decoded=decoded,
                         expected=n * fpd, one_device=one_device(mesh)))
        log(f"n={n}: {decoded}/{n * fpd} frames, {msps} Msamples/s")
    return rows


def fit(x, y):
    """Least squares y = c0 + c1 x: (c0, c1)."""
    a = np.stack([np.ones(len(x)), np.asarray(x, float)], axis=1)
    (c0, c1), *_ = np.linalg.lstsq(a, np.asarray(y, float), rcond=None)
    return float(c0), float(c1)


def projected(c_fix: float, c_lin: float):
    """Efficiency c_lin shard / (c_fix + c_lin (shard + halo)) at the
    fractions of PROJECT_AT; none where the fitted slope is not positive
    (the time does not grow with the shard: launch-bound)."""
    from opv_tpu_torch.parallel.sharded import HALO_SAMPLES
    if c_lin <= 0:
        return ("none: c_lin <= 0, the time does not grow with the shard "
                "(launch-bound)")
    out = {}
    for r in PROJECT_AT:
        shard = HALO_SAMPLES / r
        out[f"r={r}"] = c_lin * shard / (c_fix + c_lin * (shard
                                                          + HALO_SAMPLES))
    return out


def shard_size(r: float) -> int:
    from opv_tpu_torch.parallel.sharded import HALO_SAMPLES
    return int(round(HALO_SAMPLES / r / 128)) * 128


def halo_sweep(ntime: int, fractions, dev, failures: list) -> dict:
    from opv_tpu_torch.parallel.grid import rx_grid_sharded
    from opv_tpu_torch.parallel.mesh import make_mesh
    from opv_tpu_torch.parallel.sharded import HALO_SAMPLES
    from opv_tpu_torch.tools import timing
    mesh = make_mesh({"ch": 1, "time": ntime}, devices=[dev] * ntime)
    out = dict(ntime=ntime, halo_samples=HALO_SAMPLES,
               one_device=one_device(mesh))
    for cfo in (True, False):
        rows = []
        for r in fractions:
            shard = shard_size(r)
            total = ntime * shard
            samples, sent = capture(total, dev)
            mfs = shard // SPF + 2

            def run():
                return rx_grid_sharded(mesh, samples,
                                       max_frames_per_shard=mfs,
                                       estimate_cfo_flag=cfo)
            res = run()
            decoded = int(res["n"])
            true = transmitted(res["frames"], res["owned"], sent)
            if true != len(sent):
                failures.append(f"halo sweep r={r} cfo={cfo}: {true} of "
                                f"the {len(sent)} whole frames")
            t = timing.timed(run, dev, clock="host")
            rows.append(dict(halo_fraction=HALO_SAMPLES / shard,
                             shard_samples=shard, timing=t, decoded=decoded,
                             transmitted=true, whole_frames=len(sent)))
            log(f"halo sweep cfo={cfo} r={r}: {t}")
        key = "cfo_on" if cfo else "cfo_off"
        out[f"rows_{key}"] = rows
        if timing.measures(dev):
            c_fix, c_lin = fit([row["shard_samples"] + HALO_SAMPLES
                                for row in rows],
                               [row["timing"]["median_ms"] * 1e-3 / ntime
                                for row in rows])
            out.setdefault("fit_per_shard", {})[key] = dict(
                c_fix_s=c_fix, c_lin_ns_per_sample=c_lin * 1e9)
            out.setdefault("projected_efficiency", {})[key] = projected(
                max(c_fix, 0.0), c_lin)
    if not timing.measures(dev):
        out["fit_per_shard"] = out["projected_efficiency"] = \
            timing.NOT_MEASURED
    out["projected_efficiency_halo_only"] = {f"r={r}": 1 / (1 + r)
                                             for r in PROJECT_AT}
    return out


def shard_cost(fractions, dev, failures: list) -> dict:
    from opv_tpu_torch.parallel.sharded import HALO_SAMPLES
    from opv_tpu_torch.rx.fast import rx_fast
    from opv_tpu_torch.tools import timing
    rows = []
    for r in fractions:
        shard = shard_size(r)
        n_ext = shard + HALO_SAMPLES
        mfs = shard // SPF + 2
        x, sent = capture(n_ext, dev)
        res = rx_fast(x, max_frames=mfs)
        true = transmitted(res["frames"], res["frame_valid"], sent)
        if true != len(sent):
            failures.append(f"shard cost r={r}: {true} of the {len(sent)} "
                            "whole frames")
        t = timing.timed(lambda: rx_fast(x, max_frames=mfs), dev, 3)
        rows.append(dict(halo_fraction=HALO_SAMPLES / shard,
                         shard_samples=shard, ext_samples=n_ext,
                         max_frames_per_shard=mfs, timing=t,
                         decoded=int(res["n_decoded"]), transmitted=true,
                         whole_frames=len(sent)))
        log(f"shard cost r={r}: {t}")
    out = dict(halo_samples=HALO_SAMPLES, rows=rows,
               note="one shard's program (rx_fast over shard + halo, the "
                    "CFO grid included) on one device; the halo's copy "
                    "from the neighbour is not in it")
    if not timing.measures(dev):
        out["fit"] = out["projected_weak_scaling_efficiency"] = \
            timing.NOT_MEASURED
        return out
    c_fix, c_lin = fit([row["ext_samples"] for row in rows],
                       [row["timing"]["median_ms"] * 1e-3 for row in rows])
    out["fit"] = dict(c_fix_ms=c_fix * 1e3,
                      c_fix_ms_clamped_for_projection=max(c_fix, 0.0) * 1e3,
                      c_lin_ns_per_sample=c_lin * 1e9)
    out["projected_weak_scaling_efficiency"] = projected(max(c_fix, 0.0),
                                                         c_lin)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="time shards of the weak-scaling runs")
    ap.add_argument("--frames-per-dev", type=int, default=4)
    ap.add_argument("--halo-sweep", action="store_true")
    ap.add_argument("--shard-cost", action="store_true")
    ap.add_argument("--fractions", type=float, nargs="+",
                    default=[1.0, 0.5, 0.25, 0.10, 0.05])
    ap.add_argument("--json", default=None)
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    from opv_tpu_torch.tools.timing import header
    dev = resolve_device(args.device)
    out = header("scaling_bench", argv if argv is not None
                 else sys.argv[1:], dev, args.commit)
    failures = []
    out["weak_scaling"] = weak_scaling(args.devices, args.frames_per_dev,
                                       dev, failures)
    out["measures"] = ("the cost of sharding: every shard on one device"
                       if all(row["one_device"] for row in
                              out["weak_scaling"]) else "scaling")
    if args.halo_sweep:
        out["halo_sweep"] = halo_sweep(max(args.devices), args.fractions,
                                       dev, failures)
    if args.shard_cost:
        out["shard_cost"] = shard_cost(args.fractions, dev, failures)
    out["checks"] = dict(passed=not failures, failures=failures)
    txt = json.dumps(out)
    if args.json:
        pathlib.Path(args.json).write_text(txt + "\n")
    print(txt)
    for line in failures:
        log(f"check failed: {line}")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
