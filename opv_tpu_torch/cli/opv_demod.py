"""opv-demod — OPV MSK demodulator CLI, flag-compatible with the reference
binary (src/opv-demod.cpp:943-1217) and with opv_tpu's opv-demod on the
paths ported so far.

Options:
  -q        quiet
  -r        raw 134-byte frames to stdout
  -s        streaming mode (chunked, for live SDR input)
  -a BW     AFC bandwidth (default 0.001; ignored with -s --fast)
  -o HZ     initial frequency offset (ignored with -s --fast)
  -p HZ     PLL bandwidth (accepted for compat)
  --fast    with -s: the locked-grid production engine
            (LockedStreamDemodulator, pipelined): acquisition once,
            symbol-rate steady body, flywheel + re-acquisition on lock loss
  --channels N
            demodulate N concurrent channels; the input stream is
            sample-interleaved across channels (I0 Q0 I1 Q1 ... I{N-1}
            Q{N-1} per sample instant); frames are tagged [ch N] on stderr
  --buf DT  stream-buffer dtype: auto (float32), float32, bfloat16, or int8
            (the quantization step follows the input level per channel)
  --block N frames per engine block (default 4).  Larger blocks amortize
            the per-block host work over more air time at +40 ms latency
            per frame, but timing corrections happen at block boundaries,
            so sample-clock drift tolerance shrinks with N
  --metrics FILE
            JSON-lines metrics snapshots ('-' for stderr), with the
            per-block device-wait vs host-lifecycle split
  --profile DIR
            write a torch.profiler Chrome trace of the streaming run to
            DIR/opv_demod_trace.json
  --device  cuda (default), cuda:N or cpu

Not ported yet, each exits with code 2 naming the ROADMAP item that brings
it: --wideband K (item 9), batch --fast (item 10), -s without --fast, batch
mode and -c (the float64 tracking and coherent demodulators, item 11).

Exit code 0 iff at least one frame decoded (opv-demod.cpp:1124, 1216).
"""

from __future__ import annotations

import argparse
import contextlib
import sys

#: bytes per stdin read, as opv_tpu's opv-demod -s --fast reads
READ_BYTES = 65536 * 16


def _unported(args) -> str | None:
    """The stderr line of an option or mode the port does not have yet."""
    if args.wideband:
        return ("--wideband (the polyphase channelizer and WidebandReceiver) "
                "is not ported to opv_tpu_torch yet (ROADMAP item 9)")
    if args.coherent:
        return ("-c (the coherent Costas-loop demodulator) is not ported to "
                "opv_tpu_torch yet (ROADMAP item 11)")
    if not args.streaming and args.fast:
        return ("batch --fast (rx_fast) is not ported to opv_tpu_torch yet "
                "(ROADMAP item 10); use -s --fast")
    if not args.fast:
        mode = "-s without --fast (StreamingDemodulator)" if args.streaming \
            else "batch mode (rx_batch)"
        return (f"{mode}, the float64 tracking demodulator, is not ported to "
                f"opv_tpu_torch yet (ROADMAP item 11); use -s --fast")
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
    why = _unported(args)
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
    from opv_tpu_torch.io.iq import iq_bytes_to_i16_pairs
    from opv_tpu_torch.stream import LockedStreamDemodulator
    from opv_tpu_torch.utils.display import banner, print_frame, summary
    from opv_tpu_torch.utils.metrics import emit_json, locked_metrics

    if not args.quiet:
        banner("OPV MSK Demodulator with AFC v1.0 (streaming)")
    for flag, name in ((args.init_offset is not None, "-o"),
                       (args.afc_bw != 0.001, "-a")):
        if flag:
            print(f"Warning: {name} is ignored in --fast streaming mode "
                  f"(feed-forward pipeline re-estimates CFO on "
                  f"acquisition and has no AFC loop)", file=err)
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    nch = max(1, args.channels)
    metrics_out = None
    if args.metrics_file:
        metrics_out = (err if args.metrics_file == "-"
                       else open(args.metrics_file, "w"))
    # pipelined: block N computes while block N-1's results are fetched and
    # printed; the tuples are the synchronous engine's
    mc = LockedStreamDemodulator(channels=nch, pipeline=True, dtype=args.buf,
                                 block_frames=args.block or 4,
                                 timing=metrics_out is not None, device=dev)
    n_samples = 0
    n_emitted = 0
    carry = b""
    quantum = 4 * nch          # one sample instant: nch interleaved IQ pairs

    def handle(results):
        nonlocal n_emitted
        for c, fb, metric, q, _pos in results:
            n_emitted += 1
            if not args.quiet:
                if nch > 1:
                    print(f"[ch {c}]", file=err)
                print_frame(n_emitted, fb, metric, q, out=err)
            if args.raw:
                stdout.write(fb)
                stdout.flush()

    with _profiled(args.profile_dir, dev):
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
            if metrics_out is not None and \
                    len(mc.block_stats) > blocks_before:
                emit_json(locked_metrics(mc, nch, n_samples), metrics_out)
        handle(mc.flush())
    if metrics_out is not None:
        m = locked_metrics(mc, nch, n_samples)
        m["final"] = True
        emit_json(m, metrics_out)
        if metrics_out is not err:
            metrics_out.close()
    if not args.quiet:
        summary(mc.decoded, mc.perfect, n_samples / nch / CONFIG.sample_rate,
                n_samples // nch // CONFIG.samples_per_symbol, "-", 0.0,
                out=err)
    return 0 if mc.decoded > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
