"""Wideband digitizer -> frames throughput at K channels (counterpart of
tools/wideband_bench.py): WidebandReceiver (the polyphase channelizer
feeding the locked engine) on a frame-periodic wideband stream made on
the card, one row per --k.

  steady   every active channel carries one fast-TX stream of the cycle's
           frames at its own carrier with a seeded phase: the stream held
           (zero-order) x K and multiplied by the K-point comb of the
           active carriers (tools/wideband_bench.py:171-187)
  bursty   (--bursty) true narrowband MSK made at the wideband rate, each
           active channel one staggered burst of --burst-frames a cycle,
           silent for the rest, plus AWGN at --snr-db per channel
           (tools/wideband_bench.py:189-215): lock formation, flywheel
           misses, drops and re-hunts every cycle

The receiver is primed with a window, warmed over one cycle, then fed
--reps windows of one cycle each (a quantum a feed); each window is timed
on the host clock and ends in torch.cuda.synchronize(): Msamples/s and
its multiple of real time (K x 2.168 Msamples/s) as the median with the
min and max.  The channelizer alone is timed by CUDA events on one
window (device ms a quantum, with its roofline).  A row also holds each
active channel's decoded frames per window against the cycle's (steady:
the cycle's frames; bursty: its burst) and, for bursty rows, the
engine's stats() over the timed windows.

Checks (a failed one exits 1): in steady rows (no noise) every active
channel decodes the cycle's frames and nothing else, each byte-exact with
metric 0, in every timed window; in bursty rows no active channel decodes
more transmitted frames a window than its burst holds, and the active
channels decode some.  A burst's first frames go to acquisition, and an
active channel may decode none of its bursts: one that false-locks on the
noise and leakage of its silence holds that grid through its bursts (at
K = 4 channel 2 beside channel 0, as the JAX receiver does on the same
feed); transmitted_per_active shows it.

--mesh N runs the engine on a ('ch'=N) mesh naming the device N times
(one card, or the CPU with --device cpu): the row records the sharding,
and on one card its time is the cost of sharding, not a scaling figure.

    python -m opv_tpu_torch.tools.wideband_bench [--k 4 64] [--frames 4]
        [--active 8] [--reps 5] [--pipeline] [--block-frames 2]
        [--quantum-frames 0] [--bursty [--burst-frames 6] [--gap-frames 6]
        [--snr-db 12]] [--hunt-stride 1] [--mesh N] [--json FILE]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import numpy as np
import torch

SPF = 86_720
REAL_TIME_MSPS = 2.168          # one channel's sample rate, Msamples/s
TAPS = 12
FRAME_SYMBOLS = 2168


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def channelize_work(n_in: int, k: int, m: int, taps: int = TAPS):
    """(bytes, [(operations, peak rate)]) of one channelize call: the
    wideband input read once and the (K, M) complex64 output written once;
    the float32 polyphase legs (a multiply and an add per tap and real
    component) and the float64 DFT product (2 x M x 2K x 2K) on the tensor
    cores."""
    from opv_tpu_torch.tools.timing import PEAK_OPS_PER_S
    return (8 * n_in + 8 * k * m,
            [(m * k * 2 * taps * 2, PEAK_OPS_PER_S["f32"]),
             (2 * m * (2 * k) ** 2, PEAK_OPS_PER_S["f64_tensor"])])


def cycle_frames(args) -> int:
    """Frames a channel per cycle: a whole number of quanta, longer than
    the channelizer window, and for bursty rows a whole burst and gap."""
    q = args.quantum_frames
    f = max(args.frames, 2 * q)
    if args.bursty:
        f = max(f, args.burst_frames + args.gap_frames)
        f = -(-f // q) * q
    return f - f % q


def periodic_bits(f: int, q: int, dev):
    """(frames a cycle, the symbol bits of BERT frames 0..f on dev, the
    (f, 134) frames 1..f the cycle carries): the
    least f' = f, f + q, ... whose frames 1..f' hold an even number of one
    bits, so the modulator's sign state ends a cycle where frame 1 began
    it and the cycle (frame 0, whose first symbol is silent, dropped)
    repeats without a glitch."""
    from opv_tpu_torch.core.framing import (build_bert_frame, encode_frame,
                                            frame_to_symbol_bits)
    while True:
        frames = build_bert_frame("W5NYV", frame_num=np.arange(f + 1))
        bits = frame_to_symbol_bits(encode_frame(
            torch.from_numpy(frames).to(dev))).reshape(-1)
        if int(bits[FRAME_SYMBOLS:].sum()) % 2 == 0:
            return f, bits, frames[1:]
        f += q


def synthesize(k: int, f: int, bits, active, args, dev):
    """One cycle of the wideband stream, (K x f x SPF,) complex64 on dev:
    periodic_bits' frames 1..f on the active carriers."""
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.tx.modulator import (mod_reset, modulate_bits_fast,
                                            symbol_signs)
    n_wb = f * SPF * k
    ph = np.random.default_rng(0).uniform(0, 2 * np.pi, len(active))
    u = np.arange(k)
    if not args.bursty:
        comb = (np.exp(1j * ph)[None, :]
                * np.exp(2j * np.pi * np.asarray(active)[None, :]
                         * u[:, None] / k)).sum(axis=1)
        iq, _ = modulate_bits_fast(bits, mod_reset())
        s = torch.complex(iq[SPF:, 0].float(), iq[SPF:, 1].float())
        comb_d = torch.from_numpy(comb.astype(np.complex64)).to(dev)
        return s.repeat_interleave(k) * comb_d.repeat(n_wb // k)
    env = np.zeros((len(active), f), np.float32)
    for i in range(len(active)):
        st = (i * max(1, f // len(active))) % f
        for j in range(args.burst_frames):
            env[i, (st + j) % f] = 1.0
    st0 = mod_reset()
    d1, d2, _, _ = symbol_signs(bits, st0.t_xor, st0.b_n)
    d1, d2 = d1[FRAME_SYMBOLS:], d2[FRAME_SYMBOLS:]
    spsk = CONFIG.samples_per_symbol * k
    period = 160 * k
    phl = torch.from_numpy(2 * np.pi * np.arange(period) / period).to(dev)
    sn = torch.sin(phl).float().repeat(n_wb // period)
    cs = torch.cos(phl).float().repeat(n_wb // period)
    a1 = d1.float().repeat_interleave(spsk)
    a2 = d2.float().repeat_interleave(spsk)
    base = torch.complex((a2 - a1) * sn, (a2 + a1) * cs) * CONFIG.iq_amplitude
    del sn, cs, a1, a2
    total = torch.zeros(n_wb, dtype=torch.complex64, device=dev)
    for i, c in enumerate(active):
        tone = torch.from_numpy(np.exp(1j * (2 * np.pi * c * u / k + ph[i]))
                                .astype(np.complex64)).to(dev)
        gate = torch.from_numpy(env[i]).to(dev).repeat_interleave(SPF * k)
        total += base * gate * tone.repeat(n_wb // k)
    # AWGN at the wideband rate: the unit-passband branches put ~1/K of it
    # in each channel
    amp = CONFIG.iq_amplitude
    snr_ch = 10 ** (args.snr_db / 10) / CONFIG.samples_per_symbol
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = torch.randn(n_wb, dtype=torch.complex64, device=dev,
                        generator=gen)
    # randn of complex64 has variance 1 split over re and im
    total += noise * math.sqrt(k * amp * amp / snr_ch)
    return total


def wideband_row(k: int, args, dev) -> dict:
    from opv_tpu_torch.rx.channelizer import channelize
    from opv_tpu_torch.stream.wideband import WidebandReceiver
    from opv_tpu_torch.tools import timing
    act = min(args.active, k)
    active = list(range(0, k, max(1, k // act)))[:act]
    f, bits, sent_frames = periodic_bits(cycle_frames(args),
                                         args.quantum_frames, dev)
    x = synthesize(k, f, bits, active, args, dev)
    n_wb = x.shape[0]
    log(f"K={k}: {n_wb} wideband samples a cycle ({f} frames, "
        f"{len(active)} active) on {dev}")
    mesh = None
    if args.mesh:
        from opv_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh({"ch": args.mesh}, devices=[dev] * args.mesh)
    rx = WidebandReceiver(k, block_frames=args.block_frames,
                          quantum_out=args.quantum_frames * SPF,
                          pipeline=args.pipeline, timing=True, mesh=mesh,
                          hunt_stride=args.hunt_stride,
                          device=None if mesh is not None else dev)
    q = rx.quantum
    if n_wb < rx.window:
        raise SystemExit("cycle shorter than one channelizer window")
    x2 = torch.cat([x, x[: rx.window]])
    del x
    chunks = n_wb // q
    pos = [rx.window]
    windows = []

    def cycle():
        got = []
        for _ in range(chunks):
            p = pos[0] % n_wb
            got += rx.feed(x2[p:p + q])
            pos[0] += q
        windows.append(got)

    rx.feed(x2[: rx.window])
    cycle()                                   # warm every slice offset
    rx.demod.block_stats.clear()
    reacq0, refresh0 = rx.demod.reacquisitions, rx.demod.refreshes
    t = timing.timed(cycle, dev, windows=args.reps, clock="host")
    timed_windows = windows[-(args.reps if "median_ms" in t else 1):]
    expect = args.burst_frames if args.bursty else f
    sent = {bytes(fr) for fr in sent_frames}
    per_active = [[sum(r[0] == c for r in w) for w in timed_windows]
                  for c in active]
    true = [[sum(r[0] == c and r[1] in sent for r in w)
             for w in timed_windows] for c in active]
    perfect = [[sum(r[0] == c and r[1] in sent and r[2] == 0 for r in w)
                for w in timed_windows] for c in active]
    failures = []
    if args.bursty:
        if any(n > expect for row in true for n in row) or \
                not any(sum(row) for row in true):
            failures.append(f"K={k} bursty: active channels decoded "
                            f"{true} transmitted frames of {expect} a "
                            "window")
    elif any(n != expect for rows in (per_active, perfect)
             for row in rows for n in row):
        failures.append(f"K={k}: active channels decoded {per_active} "
                        f"({perfect} transmitted, metric 0) of {expect} a "
                        "window")
    buf = torch.zeros(rx.window, dtype=torch.complex64, device=dev)
    ct = timing.timed(lambda: channelize(buf, k, TAPS), dev, 10, queue=True)
    m = (rx.window - k * TAPS) // k + 1
    nbytes, work = channelize_work(rx.window, k, m)
    stats = rx.stats()
    msps = timing.rate(chunks * q, t)
    row = dict(
        k=k, active_channels=len(active),
        scenario="bursty" if args.bursty else "steady",
        block_frames=args.block_frames, quantum_frames=args.quantum_frames,
        pipeline=bool(args.pipeline), hunt_stride=args.hunt_stride,
        frames_per_chan_per_cycle=f, timing=t, wideband_msps=msps,
        x_realtime=({key: v / (k * REAL_TIME_MSPS) for key, v in msps.items()}
                    if isinstance(msps, dict) else timing.NOT_MEASURED),
        channelize=dict(timing=ct, samples_in=rx.window, samples_out=m,
                        roofline=timing.roofline(nbytes, work, ct)),
        frames_decoded_timed=sum(len(w) for w in timed_windows),
        expected_per_active_per_window=expect,
        decoded_per_active=per_active, transmitted_per_active=true,
        perfect_per_active=perfect,
        blocks_timed=stats.get("blocks"),
        device_wait_ms_mean=stats.get("device_wait_ms_mean"),
        host_ms_mean=stats.get("host_ms_mean"))
    if not timing.measures(dev):
        for key in ("device_wait_ms_mean", "host_ms_mean"):
            row[key] = timing.NOT_MEASURED
    if args.bursty:
        row.update(burst_frames=args.burst_frames, gap_frames=args.gap_frames,
                   snr_db=args.snr_db,
                   blocks_by_program=stats.get("blocks_by_program"),
                   reacquire_dispatches=int(rx.demod.reacquisitions - reacq0),
                   timing_refreshes=int(rx.demod.refreshes - refresh0),
                   device_wait_ms_max=stats.get("device_wait_ms_max"),
                   host_ms_max=stats.get("host_ms_max"))
        if not timing.measures(dev):
            for key in ("device_wait_ms_max", "host_ms_max"):
                row[key] = timing.NOT_MEASURED
    if mesh is not None:
        row["mesh"] = dict(
            ch_axis=args.mesh,
            engine_buffer_shard_rows=sorted({tuple(p.shape) for p in
                                             rx.demod._buf.parts}),
            devices=sorted({str(d) for d in mesh.devices.reshape(-1)}),
            one_device=len({str(d) for d in mesh.devices.reshape(-1)}) == 1)
    row["failures"] = failures
    log(f"K={k}: {msps} Msamples/s, decoded a window per active channel "
        f"{per_active} of {expect}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wideband_bench")
    ap.add_argument("--k", type=int, nargs="+", default=[64],
                    help="channel counts: one row each (the K sweep)")
    ap.add_argument("--frames", type=int, default=4,
                    help="frames a channel a cycle (frame-periodic)")
    ap.add_argument("--active", type=int, default=8,
                    help="channels carrying signal")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed windows, one cycle each")
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--block-frames", type=int, default=2)
    ap.add_argument("--quantum-frames", type=int, default=0,
                    help="channelizer feed quantum in frames a channel "
                         "(the receiver's quantum_out); must divide "
                         "--block-frames; 0 = the block advance")
    ap.add_argument("--bursty", action="store_true")
    ap.add_argument("--burst-frames", type=int, default=6)
    ap.add_argument("--gap-frames", type=int, default=6)
    ap.add_argument("--snr-db", type=float, default=12.0,
                    help="bursty rows' per-channel Eb/N0")
    ap.add_argument("--mesh", type=int, default=0,
                    help="the engine on a ('ch'=N) mesh naming the device "
                         "N times")
    ap.add_argument("--hunt-stride", type=int, default=1)
    ap.add_argument("--json", default=None)
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    from opv_tpu_torch.tools.timing import header
    dev = resolve_device(args.device)
    if args.quantum_frames == 0:
        args.quantum_frames = args.block_frames
    if args.block_frames % args.quantum_frames:
        raise SystemExit("--quantum-frames must divide --block-frames")
    out = header("wideband_bench", argv if argv is not None
                 else sys.argv[1:], dev, args.commit)
    out["rows"] = [wideband_row(k, args, dev) for k in args.k]
    failures = [f for row in out["rows"] for f in row.pop("failures")]
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
