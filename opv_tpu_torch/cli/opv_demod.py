"""opv-demod — OPV MSK demodulator CLI, flag-compatible with the reference
binary (src/opv-demod.cpp:943-1217) and with opv_tpu's opv-demod.

Options:
  -q        quiet
  -r        raw 134-byte frames to stdout
  -s        streaming mode (chunked, for live SDR input): the
            reference-parity tracking demodulator (StreamingDemodulator,
            float64 AFC + timing loops), with the reference's sync
            transition lines and a status line every 5 s on stderr
  (no -s)   batch mode: the whole of stdin demodulated at once (rx_batch)
  -c        coherent mode (the Costas loop, batch only; -s ignores it, as
            the reference does): experimental, it mirrors the reference's
            non-functional coherent path; a warning is printed
  -a BW     AFC bandwidth (default 0.001; ignored with -s --fast)
  -o HZ     initial frequency offset (skips the coarse estimate; ignored
            with -s --fast)
  -p HZ     PLL bandwidth (coherent only; default 50)
  --fast    batch: the feed-forward dense receiver (rx_fast: dense
            correlation at every sample offset, no tracking loop); with
            -s: the locked-grid production engine
            (LockedStreamDemodulator, pipelined): acquisition once,
            symbol-rate steady body, flywheel + re-acquisition on lock loss
  --channels N
            demodulate N concurrent channels; the input stream is
            sample-interleaved across channels (I0 Q0 I1 Q1 ... I{N-1}
            Q{N-1} per sample instant); frames are tagged [ch N] on stderr
  --wideband K
            the input is ONE digitizer stream at K x 2.168 Msamples/s; a
            K-branch polyphase channelizer splits it into K OPV channels
            feeding the locked engine (WidebandReceiver, pipelined).
            Frames are tagged [ch N] on stderr; the input is fed in quanta
            of one engine block per channel (86,720 x --block x K
            samples), so expect about a block of latency
  --buf DT  stream-buffer dtype: auto (float32), float32, bfloat16, or int8
            (the quantization step follows the input level per channel)
  --block N frames per engine block (default 4; 2 with --wideband).
            Larger blocks amortize the per-block host work over more air
            time at +40 ms latency per frame, but timing corrections happen
            at block boundaries, so sample-clock drift tolerance shrinks
            with N
  --metrics FILE
            JSON-lines metrics snapshots ('-' for stderr): with -s --fast
            the per-block device-wait vs host-lifecycle split; with -s one
            line per status line and a final one with the Viterbi metric
            histogram
  --profile DIR
            write a torch.profiler Chrome trace of the streaming run to
            DIR/opv_demod_trace.json; with -s --fast the engine runs with
            its timing records on, so the trace also carries the engine's
            and the wideband receiver's host spans (opv.append,
            opv.launch, opv.resolve, opv.slide, opv.wideband.channelize,
            ...)
  --device  cuda (default), cuda:N or cpu

Exit code 0 iff at least one frame decoded (opv-demod.cpp:1124, 1216).
"""

from __future__ import annotations

import argparse
import contextlib
import sys

#: bytes per stdin read, as opv_tpu's opv-demod -s --fast reads
READ_BYTES = 65536 * 16
#: bytes per stdin read of -s without --fast, as opv_tpu's opv-demod -s
TRACKING_READ_BYTES = 65536 * 4
#: seconds of stream between status lines of -s
STATUS_EVERY_S = 5.0
#: least bytes per stdin read with --wideband; a read holds at least one
#: quantum.  The feeds are exact quanta whatever the read size, so the
#: tuples do not depend on it.
WIDEBAND_READ_BYTES = 16 << 20


def _usage_error(args) -> str | None:
    """The stderr line of a refused combination of options."""
    if args.wideband and not (args.streaming and args.fast):
        return ("--wideband requires -s --fast (the channelizer feeds the "
                "locked streaming engine)")
    if args.wideband and args.channels > 1:
        return ("--wideband and --channels are mutually exclusive (the "
                "channelizer defines the channel count)")
    return None


@contextlib.contextmanager
def _profiled(profile_dir, dev):
    """torch.profiler over the block when profile_dir is given; its Chrome
    trace goes to profile_dir/opv_demod_trace.json on exit."""
    if not profile_dir:
        yield
        return
    import pathlib
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    out = pathlib.Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "opv_demod_trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="opv-demod", add_help=False)
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-r", dest="raw", action="store_true")
    ap.add_argument("-s", dest="streaming", action="store_true")
    ap.add_argument("-c", dest="coherent", action="store_true")
    ap.add_argument("-a", dest="afc_bw", type=float, default=0.001)
    ap.add_argument("-p", dest="pll_bw", type=float, default=50.0)
    ap.add_argument("-o", dest="init_offset", type=float, default=None)
    ap.add_argument("-h", action="store_true", dest="help")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--wideband", type=int, default=0, metavar="K")
    ap.add_argument("--buf", default="auto",
                    choices=("auto", "float32", "bfloat16", "int8"))
    ap.add_argument("--block", type=int, default=None, metavar="N")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics", dest="metrics_file", default=None)
    ap.add_argument("--profile", dest="profile_dir", default=None)
    args = ap.parse_args(argv)

    err = sys.stderr
    if args.help:
        print(__doc__, file=err)
        return 0
    why = _usage_error(args)
    if why:
        print(f"opv-demod: {why}", file=err)
        return 2

    from opv_tpu_torch.cli._device import DeviceError, resolve_device
    try:
        dev = resolve_device(args.device)
    except DeviceError as e:
        print(f"opv-demod: {e}", file=err)
        return 1

    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.utils.display import banner, print_frame, summary
    from opv_tpu_torch.utils.metrics import emit_json, locked_metrics

    if not args.quiet:
        if args.coherent:
            banner("OPV MSK Demodulator with Costas Loop v1.0 (coherent)",
                   out=err)
        else:
            banner("OPV MSK Demodulator with AFC v1.0"
                   + (" (streaming)" if args.streaming else ""), out=err)
    if args.coherent:
        print("Note: coherent mode is experimental (non-functional in the "
              "reference implementation, SURVEY.md C12); results will be "
              "poor.", file=err)
    stdout = sys.stdout.buffer

    def emit_frame(i, fb, metric, q):
        if not args.quiet:
            print_frame(i, fb, metric, q, out=err)
        if args.raw:
            stdout.write(fb)
            stdout.flush()

    if not args.streaming:
        return _batch(args, sys.stdin.buffer, dev, emit_frame)
    metrics_out = None
    if args.metrics_file:
        metrics_out = (err if args.metrics_file == "-"
                       else open(args.metrics_file, "w"))
    if not args.fast:
        with _profiled(args.profile_dir, dev):
            sd = _tracking(args, sys.stdin.buffer, dev, emit_frame,
                           metrics_out)
        if metrics_out is not None and metrics_out is not err:
            metrics_out.close()
        if not args.quiet:
            summary(sd.decoded, sd.perfect,
                    sd.total_samples / CONFIG.sample_rate, sd.total_symbols,
                    sd.sync_state, sd.freq_offset, out=err)
        return 0 if sd.decoded > 0 else 1

    for flag, name in ((args.init_offset is not None, "-o"),
                       (args.afc_bw != 0.001, "-a")):
        if flag:
            print(f"Warning: {name} is ignored in --fast streaming mode "
                  f"(feed-forward pipeline re-estimates CFO on "
                  f"acquisition and has no AFC loop)", file=err)
    n_emitted = 0
    tagged = args.channels > 1 or args.wideband > 0

    def handle(results):
        nonlocal n_emitted
        for c, fb, metric, q, _pos in results:
            n_emitted += 1
            if not args.quiet and tagged:
                print(f"[ch {c}]", file=err)
            emit_frame(n_emitted, fb, metric, q)

    def metrics(engine, channels, n_samples, final=False):
        m = locked_metrics(engine, channels, n_samples)
        if final:
            m["final"] = True
        emit_json(m, metrics_out)

    run = _wideband if args.wideband else _channels
    with _profiled(args.profile_dir, dev):
        engine, nch, n_samples = run(args, sys.stdin.buffer, dev, handle,
                                     None if metrics_out is None else metrics)
    if metrics_out is not None:
        metrics(engine, nch, n_samples, final=True)
        if metrics_out is not err:
            metrics_out.close()
    if not args.quiet:
        summary(engine.decoded, engine.perfect,
                n_samples / nch / CONFIG.sample_rate,
                n_samples // nch // CONFIG.samples_per_symbol, "-", 0.0,
                out=err)
    return 0 if engine.decoded > 0 else 1


def _batch(args, stdin, dev, emit_frame) -> int:
    """Batch mode: all of stdin through rx_batch (opv-demod.cpp:1127-1216),
    or through rx_fast with --fast."""
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.io.iq import iq_bytes_to_complex
    from opv_tpu_torch.rx.pipeline import rx_batch
    from opv_tpu_torch.stream.chunked import STATE_NAMES
    from opv_tpu_torch.utils.display import summary
    err = sys.stderr
    samples = iq_bytes_to_complex(stdin.read())
    if not args.quiet:
        print(f"Loaded {len(samples)} samples "
              f"({len(samples) / CONFIG.sample_rate:.3f} sec)", file=err)
    if len(samples) == 0:
        return 1
    if args.fast:
        return _batch_fast(args, samples, dev, emit_frame)
    out = rx_batch(samples, init_offset=args.init_offset,
                   afc_alpha=args.afc_bw, coherent=args.coherent,
                   pll_bw=args.pll_bw, device=dev)
    if not args.quiet:
        print(f"Estimated carrier offset: {float(out['est_offset']):.1f} Hz",
              file=err)
        print(f"Demodulated {int(out['n_symbols'])} symbols, final AFC "
              f"offset: {float(out['freq_offset']):.1f} Hz\n", file=err)
    decoded = perfect = 0
    for fb, metric, q in zip(out["frames"], out["metrics"], out["sync_q"]):
        decoded += 1
        perfect += int(metric == 0)
        emit_frame(decoded, bytes(fb), int(metric), float(q))
    if not args.quiet:
        summary(decoded, perfect, len(samples) / CONFIG.sample_rate,
                int(out["n_symbols"]), STATE_NAMES[int(out["tracker_state"])],
                float(out["freq_offset"]), out=err)
    return 0 if decoded > 0 else 1


def _batch_fast(args, samples, dev, emit_frame) -> int:
    """Batch --fast: the (1, N) complex64 capture through rx_fast on the
    device, max(8, N / 86,720 + 2) frame slots, the valid frames emitted
    in the order of their starts."""
    import numpy as np
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.rx.fast import rx_fast
    from opv_tpu_torch.utils.display import summary
    n = len(samples)
    if n < CONFIG.samples_per_frame + \
            CONFIG.sync_bits * CONFIG.samples_per_symbol:
        if not args.quiet:
            print("Capture shorter than one frame; nothing to decode",
                  file=sys.stderr)
        return 1
    mf = max(8, n // CONFIG.samples_per_frame + 2)
    x = torch.from_numpy(samples.astype(np.complex64))[None].to(dev)
    out = {k: v.cpu().numpy() for k, v in rx_fast(x, max_frames=mf).items()}
    valid = out["frame_valid"][0]
    frames, metrics = out["frames"][0][valid], out["metrics"][0][valid]
    qs = out["sync_q"][0][valid]
    decoded = perfect = 0
    for i in np.argsort(out["starts"][0][valid]):
        decoded += 1
        perfect += int(metrics[i] == 0)
        emit_frame(decoded, bytes(frames[i]), int(metrics[i]), float(qs[i]))
    if not args.quiet:
        summary(decoded, perfect, n / CONFIG.sample_rate,
                n // CONFIG.samples_per_symbol, "-",
                float(out["freq_offset"][0]), out=sys.stderr)
    return 0 if decoded > 0 else 1


def _tracking(args, stdin, dev, emit_frame, metrics_out):
    """-s without --fast: TRACKING_READ_BYTES reads fed to the
    StreamingDemodulator as complex128 (opv-demod.cpp:995-1125), the
    reference's sync transition lines as they happen, a status line (and a
    metrics line) every STATUS_EVERY_S seconds of stream.  Returns the
    demodulator."""
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.io.iq import iq_bytes_to_complex
    from opv_tpu_torch.stream import StreamingDemodulator
    from opv_tpu_torch.utils.display import print_sync_event, status_line
    from opv_tpu_torch.utils.metrics import (MetricHistogram, demod_metrics,
                                             emit_json)
    err = sys.stderr
    if not args.quiet:
        print("Streaming mode: processing data as it arrives...\n", file=err)
        if args.init_offset is not None:
            print(f"Initial frequency offset: {args.init_offset:.1f} Hz",
                  file=err)
    # the reference prints the transitions unconditionally
    # (src/opv-demod.cpp:651-706); -q keeps them quiet here
    sd = StreamingDemodulator(
        init_offset=args.init_offset, afc_alpha=args.afc_bw,
        on_event=None if args.quiet else print_sync_event, device=dev)
    hist = MetricHistogram()

    def emit(results):
        base_n = sd.decoded - len(results)
        for j, (fb, metric, q, _idx) in enumerate(results):
            hist.add(metric)
            emit_frame(base_n + j + 1, fb, metric, q)

    printed_offset = args.init_offset is not None
    last_status = 0.0
    while True:
        buf = stdin.read(TRACKING_READ_BYTES)
        if not buf:
            break
        emit(sd.feed(iq_bytes_to_complex(buf)))
        if not printed_offset and sd.est_offset is not None:
            if not args.quiet:
                print(f"Estimated carrier offset: {sd.est_offset:.1f} Hz\n",
                      file=err)
            printed_offset = True
        secs = sd.total_samples / CONFIG.sample_rate
        if secs - last_status >= STATUS_EVERY_S:
            if not args.quiet:
                status_line(secs, sd.total_symbols, sd.decoded, sd.perfect,
                            sd.freq_offset, sd.timing_freq, out=err)
            if metrics_out is not None:
                emit_json(demod_metrics(sd), metrics_out)
            last_status = secs
    emit(sd.flush())
    if metrics_out is not None:
        m = demod_metrics(sd)
        m["viterbi_metric_hist"] = hist.as_dict()
        emit_json(m, metrics_out)
    return sd


def _timing(args, metrics) -> bool:
    """-s --fast: the engine's timing records, for --metrics and for
    --profile's spans."""
    return metrics is not None or bool(args.profile_dir)


def _channels(args, stdin, dev, handle, metrics):
    """--channels N: READ_BYTES reads of sample-interleaved channels, each
    fed to the pipelined engine as an int16 view cast on its device.
    Returns (engine, channels, samples read over all channels)."""
    from opv_tpu_torch.io.iq import iq_bytes_to_i16_pairs
    from opv_tpu_torch.stream import LockedStreamDemodulator
    nch = max(1, args.channels)
    # pipelined: block N computes while block N-1's results are fetched and
    # printed; the tuples are the synchronous engine's
    mc = LockedStreamDemodulator(channels=nch, pipeline=True, dtype=args.buf,
                                 block_frames=args.block or 4,
                                 timing=_timing(args, metrics),
                                 device=dev)
    n_samples = 0
    carry = b""
    quantum = 4 * nch          # one sample instant: nch interleaved IQ pairs
    while True:
        buf = stdin.read(READ_BYTES)
        if not buf:
            break
        buf = carry + buf
        usable = len(buf) - len(buf) % quantum
        carry = buf[usable:]
        # wire-form (C, n, 2) int16 pairs, cast on the engine's device:
        # no complex samples between stdin and the soft stage
        x = iq_bytes_to_i16_pairs(buf, channels=nch)
        n_samples += x.shape[0] * x.shape[1]
        blocks_before = len(mc.block_stats)
        handle(mc.feed(x))
        if metrics is not None and len(mc.block_stats) > blocks_before:
            metrics(mc, nch, n_samples)
    handle(mc.flush())
    return mc, nch, n_samples


def _wideband(args, stdin, dev, handle, metrics):
    """--wideband K: reads of at least one quantum, copied to the device
    as int16 and made complex64 there (exact), fed to the pipelined
    WidebandReceiver in exact quanta; what is left after the last whole
    quantum is fed at the end.  Returns (the inner engine, K, wideband
    samples read, which are the channel samples over all K channels)."""
    import torch
    from opv_tpu_torch.io.iq import iq_bytes_to_i16_pairs
    from opv_tpu_torch.stream import WidebandReceiver
    k = args.wideband
    wb = WidebandReceiver(k, block_frames=args.block or 2, pipeline=True,
                          dtype=args.buf, timing=_timing(args, metrics),
                          device=dev)
    inner = wb.demod
    q = wb.quantum
    qbytes = 4 * q

    def samples(data):
        iq = inner._to_device(torch.from_numpy(iq_bytes_to_i16_pairs(data)[0]))
        return torch.complex(iq[:, 0].to(torch.float32),
                             iq[:, 1].to(torch.float32))

    n_samples = 0
    carry = b""
    while True:
        buf = stdin.read(max(WIDEBAND_READ_BYTES, qbytes))
        if not buf:
            break
        buf = carry + buf
        nq = len(buf) // qbytes
        carry = buf[nq * qbytes:]
        if not nq:
            continue
        x = samples(buf[: nq * qbytes])
        for i in range(nq):
            n_samples += q
            blocks_before = len(inner.block_stats)
            handle(wb.feed(x[i * q:(i + 1) * q]))
            if metrics is not None and len(inner.block_stats) > blocks_before:
                metrics(inner, k, n_samples)
    if len(carry) >= 4:
        x = samples(carry)
        n_samples += x.shape[0]
        handle(wb.feed(x))
    handle(wb.flush())
    return inner, k, n_samples


if __name__ == "__main__":
    sys.exit(main())
