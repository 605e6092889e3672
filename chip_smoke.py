#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opv_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero, nothing is caught):
  1. device   the card's name and power limit; TF32 matmuls must be off
  2. build    nvcc builds csrc/*.cu for sm_90a from this checkout
  3. viterbi  the CUDA Viterbi (radix 4 and 2) bit-identical to its plain
              twin at B = 1, 131, 1280 on clean, tie-stress, wide (values
              up to 2^15 - 1) and random input; time, bound, roofline
  4. soft     the fused soft-stage kernel against its twin at the main
              path's shapes: float32 within tolerance, the int8 dot exact;
              its launch configuration, time, bound (bytes moved over the
              HBM rate), roofline share and, for float32 rows, the time of
              torch.bmm of the correlation alone (a yardstick the port never
              calls; PyTorch has no int8 batched matmul on the card)
  5. main     64 channels x 20 frames synthesized on the card with the
              port's TX, per-channel delays; rx_locked (acquisition), then
              rx_locked_steady on float32 and int8 window rows (radix 4,
              and int8 again with radix 2): 1280/1280 frames valid, metric
              0, byte-equal to the transmitted frames; every kernel's
              launch counter > 0 over that run; steady-block latency
              (CUDA events, median of 7 single blocks after warm-up),
              throughput (20 blocks back to back between two CUDA events)
              and peak memory
  6. profile  torch.profiler over three steady blocks per buffer type:
              device time by op and the device-busy share of the block
              (Chrome traces go to build/chip_smoke/)
  7. stream   the port's streaming engine (LockedStreamDemodulator,
              synchronous, block_frames 4) on the card at 64 channels:
              channels 0-55 the main path's stream, 56-63 a 6-frame burst,
              an 8-frame noise gap and a 6-frame burst at +500 Hz, +23
              samples; fed one window, then advance-sized chunks, then
              flushed, with float32 and then int8 rows: every transmitted
              frame emitted once, byte-exact, metric 0, at its position;
              >= 2 re-acquisitions; the soft-stage (both row types) and
              radix-4 Viterbi counters grow over the two runs; the first
              soft-stage and Viterbi call of each program (steady,
              reacquire) held against the twins on the operands the engine
              gave it (64 x 10,866 rows, 256 frames).  Then the
              host-clock throughput over 12 blocks of bench.py's cyclic
              feed, and on a 4-channel impaired feed the engine on the card
              against the engine on the CPU (identical tuples, sync
              quality within 1e-4), and rx_locked_reacquire / _retime on
              its first window, card against CPU
  8. modes    the engine's other modes on the card: pipelined on the
              stream phase's feed with float32 rows and with int8 rows
              plus AGC (channels 48-55 at 1/256): every transmitted frame
              once, byte-exact, metric 0, at its position, tuples equal to
              the synchronous engine's, the weak channels' step below 1,
              each program's first K3 and K1 call held against the twins
              (the int8 one with its per-channel rescale); synchronous
              against pipelined on bench.py's cyclic feed (float32 and
              int8 + AGC, 3 alternations of 12 timed blocks, Msamples/s
              and the timing split), with a third arm whose every timed
              pipelined launch runs under
              torch.cuda.set_sync_debug_mode("error"); eager serving at
              opv-modem --fast's configuration (1 channel, block_frames 1,
              frame-sized feeds: the window-gated tuples, one frame ahead,
              p50/p95 host ms per feed); hunt_stride 2 against 1 (the same
              true frames at the same positions, re-acquire block ms); and
              the pipelined int8 AGC engine on a 4-channel feed with a weak
              channel and a level step, card against CPU twins
  9. cli      the port's command-line tools on the card: opv_mod in this
              process (exact, the default) byte-equal to the reference
              binary's captures tests/golden/bert3.iq and raw3.iq, its
              --fast -R output equal to the fast TX on the CPU; the
              phase_track kernel bit-identical to its twin over bert3, its
              ms per frame against the twin's and the exact TX per frame;
              opv_demod -s --fast -r -q --channels 64 in this process on the
              stream phase's feed as int16 wire bytes (float32 and int8
              rows, --metrics): on float32 rows every transmitted frame
              once, byte-exact; on int8 rows the frames its engine emits
              fed the same reads, and the transmitted frames lost, by
              channel; the final metrics line counting them, host-clock
              Msamples/s and its multiple of real time, again with 16 MiB
              reads (what the 1 MiB framing costs) and the view of the
              reads alone; opv_demod as a process at 1 channel with no --device
              (the default reaches the card); and opv_modem as processes:
              -R --fast delivering bert3's frames over UDP, -l --fast
              echoing frames sent at 40 ms pacing (echo latency p50/p95
              after a warm-up), -t -o with stdout equal to the tee and to
              the exact modulation
 10. the kernels JSON line (launches: the main path's, for phase_track the
     cli phase's opv_mod runs; launches_stream: the stream phase's two
     runs; launches_modes: the two pipelined runs of the modes phase;
     launches_cli: the cli phase's in-process runs), the card line, then
     the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

There is no CPU fallback: without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
from collections import Counter
import subprocess
import sys
import time

import numpy as np

# in-process CLI runs and free ports, shared with the CLI tests
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
from cli_support import free_port, run_main  # noqa: E402

CHANNELS = 64
FRAMES = 20
#: soft stage: |kernel - twin| <= SOFT_RTOL * max|twin| (float32 sums of 80
#: products taken in another order, and fused multiply-adds in the combine)
SOFT_RTOL = 1e-5
KERNEL_REPS = 20
#: published H100 SXM peaks (NVIDIA's H100 datasheet): HBM bytes/s, and
#: operations/s for float32 outside the tensor cores and for int8
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12,
                  # float64 outside the tensor cores (the same datasheet)
                  "f64": 34e12}
#: int32 operations of the Viterbi per trellis state per step: two adds
#: (each predecessor's path metric plus its branch metric), a compare of
#: the two candidates and a select of the survivor
VITERBI_OPS_PER_STATE_STEP = 4
#: ... and per step, shared by all 64 states: the four distinct branch
#: metrics of a rate-1/2 code (one per pair of expected output bits)
VITERBI_OPS_PER_STEP = 4
STEADY_REPS = 7
THROUGHPUT_BLOCKS = 20
SPF = 86_720                  # samples per frame
#: the receiver's kernels (phase_track, the exact TX's, runs in phase 9)
RX_KERNELS = ("viterbi_r4", "viterbi_r2", "symbol_soft[float32]",
              "symbol_soft[int8]")
#: the stream phase: the engine at the main path's width, block_frames 4;
#: channels 0..55 carry the main path's stream, the rest a burst of 6
#: frames, an 8-frame noise gap (lock lost) and 6 frames at +500 Hz and
#: +23 samples (a mixed-lock re-acquire)
STREAM_BF = 4
STREAM_CLEAN = 56
STREAM_BURST_FRAMES = 6
STREAM_GAP_FRAMES = 8
STREAM_BURST_CFO_HZ = 500.0
STREAM_BURST_SHIFT = 23
#: numpy seeds of the gap noise of channels 56..63 (see gap_burst)
STREAM_GAP_SEEDS = (1, 3, 4, 5, 6, 7, 8, 10)
#: card against CPU twins: sync quality within this (float32 sums in
#: another order); chunk size of those feeds (exercises the sub-row pend)
STREAM_Q_TOL = 1e-4
STREAM_TWIN_CHUNK = 70_001
STREAM_WARM_BLOCKS = 5
STREAM_TIMED_BLOCKS = 12
#: the modes phase: channels of the stream feed scaled by MODES_WEAK_GAIN
#: in the int8 AGC runs (AGC must adopt a finer step there); alternations
#: of the synchronous/pipelined A/B; the AGC cadence of the 4-channel
#: card-vs-CPU check (a level step mid-stream is re-quantized at once)
MODES_WEAK = slice(48, 56)
MODES_WEAK_GAIN = 1.0 / 256.0
MODES_ALTERNATIONS = 3
MODES_AGC_BLOCKS = 2
#: the cli phase: frames echoed by opv_modem -l --fast at a frame's pacing
#: (warm-up, then timed); timed phase_track calls; seconds a modem process
#: may take to listen; the larger read of opv_demod's framing check (MiB)
CLI_ECHO_WARM = 10
CLI_ECHO_FRAMES = 40
CLI_PACING_S = 0.040
CLI_TRACK_REPS = 5
CLI_START_S = 120
CLI_BIG_READ = 16
REAL_TIME_MSPS = 2.168        # one channel's sample rate, Msamples/s


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (one warm-up first)."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int) -> float:
    """Median of reps individually event-timed calls (after a warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def bound(nbytes: float, nops: float, ops_per_s: float):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate
    and operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; the port's "
                         "main path needs one GPU")
    card = nvidia_smi("name,power.limit")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the float32 twins need "
                             "full float32")
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")
    return card, int32_ops_per_s()


def int32_ops_per_s() -> float:
    """The card's int32 issue rate: 64 lanes per SM at the max SM clock."""
    import torch
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * sm_mhz * 1e6


def viterbi_bound(b: int, int_ops_per_s: float):
    """(bound ms, what bounds it) of B frames: each soft value read once
    (int32), each bit and metric written once, against the int32 issue of
    every state's add-compare-select at every trellis step."""
    eb, fb = 2144, 1072
    nbytes = b * (eb * 4 + fb + 4)
    nops = b * fb * (64 * VITERBI_OPS_PER_STATE_STEP + VITERBI_OPS_PER_STEP)
    return bound(nbytes, nops, int_ops_per_s)


def phase_build():
    from opv_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.library()
    info = build.BUILD_INFO
    log(f"[build] {info['path']} in {info['seconds']:.1f} s nvcc, "
        f"{time.perf_counter() - t0:.1f} s total")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def wide_rows(rng) -> np.ndarray:
    """Rows beyond the main path's 0..7 that the Viterbi's contract covers
    (any value below 2^15): uniform in 0..2^15-1, whose best metrics lie
    below -2^25, so a metric * 64 + state key wraps int32."""
    return rng.integers(0, 2**15, (5, 2144))


def straddle_rows() -> np.ndarray:
    """Two seeded rows whose 64 final metrics straddle -2^25: a metric * 64
    + state key there picks the wrong end state, not only a wrong metric."""
    return np.random.default_rng(5).integers(0, 31600, (40, 2144))[[3, 24]]


def viterbi_inputs(b: int, dev, rng):
    """The clean encodes (metric 0), the tie-stress rows of the JAX
    package's Pallas tests, the wide and straddle rows, then random 0..7
    rows: the first b of them, and the clean frames' bits."""
    import torch
    from opv_tpu_torch.core.convcode import conv_encode_bits
    eb, fb = 2144, 1072
    u = torch.from_numpy(rng.integers(0, 2, (3, fb)).astype(np.uint8)).to(dev)
    clean = torch.where(conv_encode_bits(u) == 1, 7, 0).to(torch.int32)
    tie = np.concatenate([rng.integers(0, 2, (4, eb)), np.zeros((2, eb)),
                          np.full((2, eb), 7), rng.integers(3, 5, (2, eb))])
    rand = rng.integers(0, 8, (b, eb))
    rows = np.concatenate([tie, wide_rows(rng), straddle_rows(), rand])
    soft = torch.cat([clean, torch.from_numpy(rows.astype(np.int32)).to(dev)])
    return soft[:b].contiguous(), u


def hold_viterbi(soft, radix: int, what: str):
    """The Viterbi kernel of `radix` against its twin on `soft` (B, 2144),
    bit for bit.  Returns (bits, metrics, error): the error is the larger
    of the most differing bits in a frame and the largest metric
    difference, which is 0 whenever this returns."""
    import torch
    from opv_tpu_torch.ops import viterbi as vit
    bits_k, met_k = vit.CUDA_KERNELS[radix](soft)
    bits_t, met_t = vit.viterbi_reference(soft, radix)
    if not (torch.equal(bits_k, bits_t) and torch.equal(met_k, met_t)):
        bad = (bits_k != bits_t).any(1) | (met_k != met_t)
        raise AssertionError(
            f"{what}: viterbi radix {radix} B={soft.shape[0]}: kernel != twin "
            f"on rows {torch.nonzero(bad)[:8, 0].tolist()}")
    err = max(int((bits_k != bits_t).sum(1).max()),
              int((met_k - met_t).abs().max()))
    return bits_k, met_k, err


def phase_viterbi(dev, int_ops_per_s: float):
    import torch
    from opv_tpu_torch.ops import viterbi as vit
    rng = np.random.default_rng(11)
    stats = {}
    for radix in (4, 2):
        kern = vit.CUDA_KERNELS[radix]
        # differing bits per frame, or the metric difference, whichever is
        # larger, over every B checked
        err = 0
        for b in (1, 131, 1280):
            soft, u = viterbi_inputs(b, dev, rng)
            bits_k, met_k, e = hold_viterbi(soft, radix, "viterbi")
            err = max(err, e)
            n_clean = min(3, soft.shape[0])
            if not (torch.equal(bits_k[:n_clean], u[:n_clean])
                    and int(met_k[:n_clean].abs().sum()) == 0):
                raise AssertionError(f"viterbi radix {radix}: clean encode "
                                     "not decoded with metric 0")
        ms = cuda_ms(lambda: kern(soft), KERNEL_REPS)
        plain = cuda_ms(lambda: vit.viterbi_reference(soft, radix), 2)
        b = soft.shape[0]
        bound_ms, bound_by = viterbi_bound(b, int_ops_per_s)
        stats[radix] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                            bound_ms=bound_ms, bound_by=bound_by,
                            roofline=bound_ms / ms, library_ms=None)
        log(f"[viterbi] radix {radix}: bit-identical to the twin at B=1,131,"
            f"{b} (clean, tie stress, wide, random); B={b}: kernel {ms:.4f} ms,"
            f" twin {plain:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"roofline {100 * bound_ms / ms:.1f}%")
    return stats


def transmission(n_frames: int, dev, start: int = 0):
    """A BERT transmission through the port's TX on `dev`: ((N,) complex64
    with the modulator's trailing zero flush, (n_frames, 134) uint8
    frames numbered start, start + 1, ...)."""
    import torch
    from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
    from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                            modulate_frames, tx_flush_zeros)
    frames = torch.from_numpy(build_bert_frame(
        "W5NYV", frame_num=start + np.arange(n_frames))).to(dev)
    iq, _ = modulate_frames(encode_frame(frames))
    return (iq_int16_to_complex(torch.cat([iq, tx_flush_zeros(device=dev)])),
            frames)


def synthesize(dev):
    """(C, N) complex64 on the card: the 20-frame BERT stream through the
    port's TX, channel c delayed by (c % 40) + 487 c samples."""
    import torch
    s, frames = transmission(FRAMES, dev)
    delays = [(c % 40) + 487 * c for c in range(CHANNELS)]
    n = -(-(len(s) + max(delays)) // 40) * 40
    x = torch.zeros((CHANNELS, n), dtype=torch.complex64, device=dev)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s
    return x, frames, delays


def hold_soft(ops, nsym: int, what: str):
    """The soft-stage kernel against its twin on `ops` (rows, kern, resc,
    phi): the soft values within SOFT_RTOL of max|twin|, and the raw
    correlation too (exact for int8 rows).  Returns (max |kernel - twin|,
    max|twin|, a note on the correlation)."""
    import torch
    from opv_tpu_torch.ops import symbol_soft as ss
    got = ss.symbol_soft_cuda(*ops, nsym)
    want = ss.symbol_soft_reference(*ops, nsym)
    raw_k = ss.symbol_soft_cuda(*ops, nsym, raw=True)
    raw_t = ss.symbol_soft_reference(*ops, nsym, raw=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale_ref = float(want.abs().max())
    if not err <= SOFT_RTOL * scale_ref:
        raise AssertionError(f"{what}: max |kernel - twin| {err:.4g} "
                             f"> {SOFT_RTOL} x {scale_ref:.4g}")
    if ops[0].dtype == torch.int8:
        if not torch.equal(raw_k, raw_t):
            raise AssertionError(f"{what}: s32 dot differs from the twin's "
                                 "int32 contraction")
        return err, scale_ref, "s32 dot exact"
    raw_err = float((raw_k - raw_t).abs().max())
    raw_ref = float(raw_t.abs().max())
    if not raw_err <= SOFT_RTOL * raw_ref:
        raise AssertionError(f"{what} correlation: {raw_err:.4g} > "
                             f"{SOFT_RTOL} x {raw_ref:.4g}")
    return err, scale_ref, f"correlation max err {raw_err:.4g} of {raw_ref:.4g}"


def phase_soft(x, dev):
    import torch
    from opv_tpu_torch.ops import symbol_soft as ss
    from opv_tpu_torch.rx.locked import soft_stage_operands, to_window_rows
    rng = np.random.default_rng(5)
    c = x.shape[0]
    r = torch.from_numpy(rng.integers(0, 40, c)).to(dev)
    foff = torch.from_numpy(rng.uniform(-300, 300, c).astype(np.float32)).to(dev)
    frac = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)).to(dev)
    scale = torch.from_numpy(rng.uniform(100, 160, c).astype(np.float32)).to(dev)
    stats = {}
    for name, dt, sc in (("f32", torch.float32, None), ("int8", torch.int8, scale)):
        rows_all = to_window_rows(x, dt)
        nsym = rows_all.shape[1] - 1
        ops = soft_stage_operands(rows_all, r, foff, nsym, sc, frac)
        err, scale_ref, raw_note = hold_soft(ops, nsym, f"soft {name}")
        rows, kern = ops[0][:, : nsym + 1], ops[1]
        nbytes = ss.moved_bytes(*ops, nsym)
        bound_ms, bound_by = bound(nbytes, 2 * rows.numel() * 8,
                                   PEAK_OPS_PER_S[name])
        ms = cuda_ms(lambda: ss.symbol_soft_cuda(*ops, nsym), KERNEL_REPS)
        plain = cuda_ms(lambda: ss.symbol_soft_reference(*ops, nsym), 3)
        library = (cuda_ms(lambda: torch.bmm(rows, kern), KERNEL_REPS)
                   if dt == torch.float32 else None)
        cfg = ss.kernel_config(dt == torch.int8)
        stats[name] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                           max_rel_err=err / scale_ref, bound_ms=bound_ms,
                           bound_by=bound_by, roofline=bound_ms / ms,
                           library_ms=library, config=cfg)
        lib_note = (f"torch.bmm of the correlation {library:.4f} ms"
                    if library is not None else
                    "library_ms null: PyTorch has no int8 batched matmul on "
                    "the card")
        log(f"[soft] {name} rows ({c}, {rows_all.shape[1]}, 80), nsym {nsym}: "
            f"max |kernel - twin| {err:.4g} of max|soft| {scale_ref:.4g} "
            f"(rel {err / scale_ref:.3g}); {raw_note}; kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"roofline {100 * bound_ms / ms:.1f}%; {lib_note}; twin "
            f"{plain:.3f} ms; config {cfg}")
        del rows_all, ops, rows, kern
    return stats


def phase_main(x, frames, delays, dev, card):
    import torch
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.rx.locked import rx_locked, rx_locked_steady, to_window_rows
    c, n = x.shape
    want_p0 = torch.tensor(delays, dtype=torch.int32, device=dev)

    def check(out, what):
        fv = int(out["frame_valid"].sum())
        bad_metric = int((out["metrics"] != 0).sum())
        same = bool((out["frames"] == frames[None]).all())
        if not (fv == c * FRAMES and bad_metric == 0 and same):
            raise AssertionError(f"{what}: {fv}/{c * FRAMES} frames valid, "
                                 f"{bad_metric} nonzero metrics, frames "
                                 f"byte-equal: {same}")

    rows_f = to_window_rows(x, torch.float32)
    rows_q = to_window_rows(x, torch.int8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    acq = rx_locked(x, n_frames=FRAMES, estimate_cfo_flag=True)
    torch.cuda.synchronize()
    t_acq = time.perf_counter() - t0
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]
    outs = {"rx_locked": acq,
            "steady f32": rx_locked_steady(rows_f, p0, foff, FRAMES, frac=frac),
            "steady int8": rx_locked_steady(rows_q, p0, foff, FRAMES, frac=frac)}
    registry.set_viterbi_radix(2)
    outs["steady int8 radix 2"] = rx_locked_steady(rows_q, p0, foff, FRAMES,
                                                   frac=frac)
    registry.set_viterbi_radix(4)
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for what, out in outs.items():
        check(out, what)
    if not torch.equal(p0, want_p0):
        raise AssertionError(f"p0 {p0.tolist()} != delays {delays}")
    if min(launches[k] for k in RX_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    log(f"[main] {c} ch x {FRAMES} frames, N={n}: rx_locked + 3 steady runs "
        f"all {c * FRAMES}/{c * FRAMES} valid, metric 0, byte-exact; p0 = "
        f"delays; |freq_offset| <= {float(foff.abs().max()):.3f} Hz; "
        f"acquisition {t_acq:.2f} s host clock; launches {launches}; peak "
        f"memory {peak / 2**30:.2f} GiB ({card})")
    steady = {}
    for name, rows in (("f32", rows_f), ("int8", rows_q)):
        def block():
            return rx_locked_steady(rows, p0, foff, FRAMES, frac=frac)
        latency = median_ms(block, STEADY_REPS)
        window = cuda_ms(block, THROUGHPUT_BLOCKS)
        steady[name] = dict(latency_ms=latency, ms_per_block=window,
                            msamples_s=c * n / window / 1e3)
        log(f"[main] steady {name}: latency {latency:.3f} ms (median of "
            f"{STEADY_REPS} single blocks); {THROUGHPUT_BLOCKS} blocks back to "
            f"back {window:.3f} ms/block = {c * n / window / 1e3:.1f} "
            f"Msamples/s ({card})")
    return launches, steady, peak, (rows_f, rows_q, p0, foff, frac)


def gap_burst(dev, seed: int = 1):
    """One channel of the lock-loss pattern, (N,) complex64 on `dev`: a
    6-frame burst, an 8-frame gap of AWGN (sigma 50 per component, numpy's
    generator from `seed`), then a 6-frame burst 23 samples later at +500
    Hz.  Also its frames with their sync positions: [(frame bytes,
    position)].

    Whether every frame of burst 2 is kept depends on the gap's noise, in
    the JAX package's engine as in the port's: a noise slot whose sync
    quality reaches 0.70 resets the flywheel's miss count, so the lock can
    outlive the gap and burst 2's first frame is lost, as the reference's
    tracker loses it (src/opv-demod.cpp:695-713).  The seeds used here keep
    every frame on float32 and int8 rows (checked on the CPU twins); seed
    2 loses two frames on float32 rows and seed 9 six on int8 rows, in
    both packages (tests/test_torch_stream_gap.py, one channel)."""
    import torch
    s1, f1 = transmission(STREAM_BURST_FRAMES, dev)
    s2, f2 = transmission(STREAM_BURST_FRAMES, dev, start=100)
    rng = np.random.default_rng(seed)
    m = STREAM_GAP_FRAMES * SPF
    gap = torch.from_numpy((50.0 * (rng.standard_normal(m)
                                    + 1j * rng.standard_normal(m))
                            ).astype(np.complex64)).to(dev)
    from opv_tpu_torch.config import CONFIG
    t = torch.arange(len(s2), dtype=torch.float64, device=dev)
    ph = 2 * np.pi * STREAM_BURST_CFO_HZ * t / CONFIG.sample_rate
    s2 = s2 * torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
    lead = torch.zeros(STREAM_BURST_SHIFT, dtype=torch.complex64, device=dev)
    b2 = len(s1) + m + STREAM_BURST_SHIFT
    want = ([(f, k * SPF) for k, f in enumerate(f1)]
            + [(f, b2 + k * SPF) for k, f in enumerate(f2)])
    return torch.cat([s1, gap, lead, s2]), want


def padded(x, n: int):
    """x zero-padded (or cut) to n samples along its last axis."""
    import torch.nn.functional as F
    return F.pad(x, (0, n - x.shape[-1]))


def stream_feed(x, frames, delays, dev):
    """The stream phase's (C, N) feed: channels 0..STREAM_CLEAN-1 carry the
    main path's stream at its delays, the rest the gap-burst pattern.
    Returns the feed and, per channel, [(frame bytes, sync position)]."""
    bursts = [gap_burst(dev, seed=STREAM_GAP_SEEDS[c - STREAM_CLEAN])
              for c in range(STREAM_CLEAN, x.shape[0])]
    n = max([x.shape[1]] + [len(b) for b, _ in bursts])
    feed = padded(x, -(-n // 40) * 40)
    want = [[(f, d + k * SPF) for k, f in enumerate(frames)] for d in delays]
    for c, (b, w) in enumerate(bursts, start=STREAM_CLEAN):
        feed[c], want[c] = padded(b, feed.shape[1]), w
    return feed, want


def spy_kernels(sd):
    """Keep a copy of the operands of the first soft-stage and the first
    Viterbi call of each program the engine `sd` runs (steady,
    reacquire), as the registry hands them to the kernels, so they can be
    held against the twins after the run without counting as its
    launches.  Returns ({(program, "soft" | "viterbi"): args}, filled as
    the engine runs; a function that removes the spies)."""
    import torch
    from opv_tpu_torch.ops import registry
    held, prog = {}, []
    for name in ("steady", "reacquire"):
        def run(*a, _fn=getattr(sd, "_" + name), _name=name):
            prog.append(_name)
            out = _fn(*a)
            prog.pop()
            return out
        setattr(sd, "_" + name, run)
    entries = {"soft": registry.symbol_soft, "viterbi": registry.viterbi_batch}

    def spy(kind):
        def call(*a):
            held.setdefault((prog[-1], kind), tuple(
                v.clone() if isinstance(v, torch.Tensor) else v for v in a))
            return entries[kind](*a)
        return call

    registry.symbol_soft, registry.viterbi_batch = spy("soft"), spy("viterbi")

    def remove():
        registry.symbol_soft = entries["soft"]
        registry.viterbi_batch = entries["viterbi"]
    return held, remove


def drive_stream(feed, dev, dtype: str, spy: bool = True, **engine):
    """The port's engine over `feed` as a stream: one window, then
    advance-sized chunks, then flush() (each chunk completes one block).
    `engine`: more LockedStreamDemodulator options (agc defaults to off).
    Returns (tuples, engine, [(block tags, host ms)] per call, the
    kernels' operands kept by spy_kernels, or {} without `spy`)."""
    import torch
    from opv_tpu_torch.stream import LockedStreamDemodulator
    sd = LockedStreamDemodulator(feed.shape[0], block_frames=STREAM_BF,
                                 dtype=dtype, device=dev, timing=True,
                                 **{"agc": False, **engine})
    held, remove_spies = spy_kernels(sd) if spy else ({}, lambda: None)
    n = feed.shape[1]
    calls = [lambda: sd.feed(feed[:, :sd.window])]
    calls += [lambda p=p: sd.feed(feed[:, p:p + sd.advance])
              for p in range(sd.window, n, sd.advance)]
    calls.append(sd.flush)
    out, per_call = [], []
    for call in calls:
        nb = len(sd.block_stats)
        t0 = time.perf_counter()
        out += call()
        torch.cuda.synchronize(dev)
        per_call.append(([b["tag"] for b in sd.block_stats[nb:]],
                         (time.perf_counter() - t0) * 1e3))
    remove_spies()
    return out, sd, per_call, held


def hold_stream_kernels(held, what: str) -> list:
    """Each kept kernel call of one engine run against its twin: the
    soft stage within SOFT_RTOL (its int8 dot exact), the Viterbi (the
    registry's radix) bit for bit.  Both programs must have run both
    kernels.  Returns one summary dict per call held."""
    import torch
    from opv_tpu_torch.ops import registry
    need = {(p, k) for p in ("steady", "reacquire") for k in ("soft", "viterbi")}
    if set(held) != need:
        raise AssertionError(f"stream {what}: kernel calls kept "
                             f"{sorted(held)}, need {sorted(need)}")
    radix = registry.get_viterbi_radix()
    stats = []
    for (prog, kind), args in sorted(held.items()):
        name = f"stream {what} {prog}"
        if kind == "soft":
            *ops, nsym = args
            err, ref, _ = hold_soft(ops, nsym, f"{name} soft")
            rows = "int8" if ops[0].dtype == torch.int8 else "float32"
            stats.append(dict(run=what, program=prog,
                              kernel=f"symbol_soft[{rows}]",
                              shape=list(ops[0].shape), nsym=nsym,
                              max_abs_err=err, max_rel_err=err / ref))
        else:
            _, _, err = hold_viterbi(args[0], radix, f"{name} viterbi")
            stats.append(dict(run=what, program=prog,
                              kernel=f"viterbi_r{radix}",
                              shape=list(args[0].shape), max_abs_err=err))
    return stats


def check_stream(out, want, what: str) -> None:
    """Every transmitted frame emitted exactly once, byte-equal, metric 0,
    at its sync position (+-1 sample); any other tuple is a flywheel frame
    over a gap (nonzero metric) on a gap-burst channel."""
    for c, frames in enumerate(want):
        mine = [r for r in out if r[0] == c]
        expect = {bytes(f.cpu().numpy()): p for f, p in frames}
        seen = [r for r in mine if r[1] in expect]
        bad = [(r[2], r[4]) for r in seen
               if r[2] != 0 or abs(r[4] - expect[r[1]]) > 1]
        if len(seen) != len(expect) or len({r[1] for r in seen}) != len(expect) \
                or bad:
            raise AssertionError(
                f"stream {what} channel {c}: {len(seen)} of {len(expect)} "
                f"frames emitted ({len({r[1] for r in seen})} distinct); "
                f"wrong metric or position: {bad[:4]}")
        extra = [(r[2], r[4]) for r in mine if r[1] not in expect]
        if extra and (c < STREAM_CLEAN or any(m == 0 for m, _ in extra)):
            raise AssertionError(f"stream {what} channel {c}: frames not "
                                 f"transmitted were emitted: {extra[:4]}")


def same_stream(got, want, what: str) -> None:
    """Tuple streams equal: channel, bytes, metric and position, and the
    sync quality within STREAM_Q_TOL."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tuples against {len(want)}")
    for g, w in zip(got, want):
        if (g[0], g[1], g[2], g[4]) != (w[0], w[1], w[2], w[4]) \
                or abs(g[3] - w[3]) > STREAM_Q_TOL:
            raise AssertionError(f"{what}: tuple {(g[0], g[2], g[3], g[4])} "
                                 f"against {(w[0], w[2], w[3], w[4])}")


def impaired_feed(x, dev, seed: int = STREAM_GAP_SEEDS[0]):
    """(4, N) complex64 on `dev` from the main path's stream: channel 0
    clean, channels 1 and 2 in AWGN (sigma 2000 per component), channel 3
    the gap-burst pattern.  Returns the feed and the grids of 0-2."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = 2000.0 * torch.complex(
        torch.randn((2, x.shape[1]), generator=g, device=dev),
        torch.randn((2, x.shape[1]), generator=g, device=dev))
    burst, _ = gap_burst(dev, seed=seed)
    feed = torch.stack([x[0], x[1] + noise[0], x[2] + noise[1],
                        padded(burst, x.shape[1])])
    return feed, [(c % 40) + 487 * c for c in range(3)]


def stream_twin_checks(feed, grid, dev):
    """The engine on the card against the engine on the CPU (the twins) on
    `feed`, float32 and int8 rows; then rx_locked_reacquire (mixed keep)
    and rx_locked_retime on the feed's first window, card against CPU.
    Returns a summary dict."""
    import torch
    from opv_tpu_torch.rx.locked import rx_locked_reacquire, rx_locked_retime
    from opv_tpu_torch.stream import LockedStreamDemodulator
    cpu = torch.device("cpu")
    tuples = {}
    for dtype in ("float32", "int8"):
        runs = []
        for d in (dev, cpu):
            sd = LockedStreamDemodulator(feed.shape[0], block_frames=STREAM_BF,
                                         dtype=dtype, agc=False, device=d)
            src = feed.to(d)
            out = []
            for off in range(0, src.shape[1], STREAM_TWIN_CHUNK):
                out += sd.feed(src[:, off:off + STREAM_TWIN_CHUNK])
            runs.append((out + sd.flush(), sd.reacquisitions))
        same_stream(runs[0][0], runs[1][0], f"stream engine {dtype} card vs cpu")
        if runs[0][1] != runs[1][1]:
            raise AssertionError(f"{dtype}: reacquisitions {runs[0][1]} on the "
                                 f"card, {runs[1][1]} on the cpu")
        tuples[dtype] = len(runs[0][0])
    window = (STREAM_BF + 1) * SPF + 1040
    win = feed[:, :window]
    keep = torch.tensor([True, False, True, False])
    p0 = torch.tensor([grid[0], 0, grid[2], 0], dtype=torch.int32)
    foff = torch.zeros(4)
    frac = torch.tensor([0.5, 0.0, 0.25, 0.0])
    r_dev = rx_locked_reacquire(win, p0.to(dev), foff.to(dev), keep.to(dev),
                                STREAM_BF, frac_old=frac.to(dev))
    r_cpu = rx_locked_reacquire(win.to(cpu), p0, foff, keep, STREAM_BF,
                                frac_old=frac)
    p0_t = torch.tensor(grid + [0], dtype=torch.int32)
    t_dev = rx_locked_retime(win, p0_t.to(dev), foff.to(dev), STREAM_BF)
    t_cpu = rx_locked_retime(win.to(cpu), p0_t, foff, STREAM_BF)
    for k in ("p0", "frames", "metrics", "burst_only", "frame_valid"):
        if not torch.equal(r_dev[k].cpu(), r_cpu[k]):
            raise AssertionError(f"rx_locked_reacquire {k}: card "
                                 f"{r_dev[k].cpu().tolist()[:4]} cpu "
                                 f"{r_cpu[k].tolist()[:4]}")
    errs = dict(
        reacquire_freq_offset=float((r_dev["freq_offset"].cpu()
                                     - r_cpu["freq_offset"]).abs().max()),
        reacquire_frac=float((r_dev["frac"].cpu() - r_cpu["frac"]).abs().max()),
        retime_frac=float((t_dev[1].cpu() - t_cpu[1]).abs().max()))
    if not torch.equal(t_dev[0].cpu(), t_cpu[0]):
        raise AssertionError(f"rx_locked_retime delta: card "
                             f"{t_dev[0].cpu().tolist()} cpu {t_cpu[0].tolist()}")
    if errs["reacquire_freq_offset"] > 1.0 or max(
            errs["reacquire_frac"], errs["retime_frac"]) > 1e-3:
        raise AssertionError(f"card vs cpu beyond 1 Hz / 1e-3 samples: {errs}")
    return dict(tuples=tuples, reacquire_p0=r_dev["p0"].cpu().tolist(),
                burst_only=r_dev["burst_only"].cpu().tolist(),
                retime_delta=t_dev[0].cpu().tolist(), **errs)


def stream_throughput(x, dev, dtype: str, strict: bool = False, **engine):
    """bench.py's streaming pattern: the clean stream (its zero tail
    dropped) as a cyclic feed; one window, STREAM_WARM_BLOCKS advance-sized
    blocks to warm up, then STREAM_TIMED_BLOCKS timed on the host clock,
    lifecycle and result fetch included.  `engine`: more engine options
    (agc defaults to off); `strict` (pipelined engines): every timed
    block's predicted launch runs under strict_launches.  Returns
    (Msamples/s, ms per block, the timed blocks' engine records: tag,
    device_wait_ms (the wait for the block's results) and host_ms (the
    lifecycle))."""
    import torch
    from opv_tpu_torch.stream import LockedStreamDemodulator
    sd = LockedStreamDemodulator(x.shape[0], block_frames=STREAM_BF,
                                 dtype=dtype, device=dev, timing=True,
                                 **{"agc": False, **engine})
    n = FRAMES * SPF
    adv, win = sd.advance, sd.window
    if n % adv or n <= win:
        raise ValueError("geometry not cyclic-compatible")
    x2 = torch.cat([x[:, :n], x[:, :win]], dim=1)
    sd.feed(x2[:, :win])
    pos = win
    for _ in range(STREAM_WARM_BLOCKS):
        sd.feed(x2[:, pos % n: pos % n + adv])
        pos += adv
    torch.cuda.synchronize(dev)
    nb = len(sd.block_stats)
    checked = strict_launches(sd) if strict else None
    t0 = time.perf_counter()
    for _ in range(STREAM_TIMED_BLOCKS):
        sd.feed(x2[:, pos % n: pos % n + adv])
        pos += adv
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if strict and checked[0] != STREAM_TIMED_BLOCKS:
        raise AssertionError(f"{checked[0]} of {STREAM_TIMED_BLOCKS} timed "
                             "pipelined blocks launched as predicted")
    return (STREAM_TIMED_BLOCKS * x.shape[0] * adv / dt / 1e6,
            dt * 1e3 / STREAM_TIMED_BLOCKS, sd.block_stats[nb:])


def phase_stream(x, frames, delays, dev, card):
    """The port's streaming engine on the card at the main path's width."""
    import torch
    from opv_tpu_torch.ops import registry
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    feed, want = stream_feed(x, frames, delays, dev)
    registry.set_viterbi_radix(4)
    runs, launches, held = {}, {}, []
    for dtype in ("float32", "int8"):
        registry.reset_launch_counts()
        out, sd, per_call, kept = drive_stream(feed, dev, dtype)
        for k, v in registry.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        held += hold_stream_kernels(kept, dtype)
        del kept
        check_stream(out, want, dtype)
        if sd.reacquisitions < 2:
            raise AssertionError(f"stream {dtype}: {sd.reacquisitions} "
                                 "re-acquisitions, the hunt and the re-hunt "
                                 "need 2")
        reacq = [ms for tags, ms in per_call if tags == ["reacquire"]]
        runs[dtype] = dict(tuples=len(out), decoded=sd.decoded,
                           perfect=sd.perfect,
                           reacquisitions=sd.reacquisitions,
                           blocks=sd.stats()["blocks_by_program"],
                           reacquire_block_ms=reacq,
                           calls_ms=[round(ms, 3) for _, ms in per_call])
    need = ("viterbi_r4", "symbol_soft[float32]", "symbol_soft[int8]")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"a kernel of the stream path never launched: "
                             f"{launches}")
    n_want = sum(len(w) for w in want)
    for dtype, r in runs.items():
        log(f"[stream] {dtype} rows, {x.shape[0]} ch x {x.shape[1]} samples, "
            f"block_frames {STREAM_BF}: {n_want}/{n_want} transmitted frames "
            f"emitted once, byte-exact, metric 0, at their positions "
            f"({r['tuples']} tuples); re-acquisitions {r['reacquisitions']}; "
            f"blocks {r['blocks']}; re-acquire blocks "
            f"{[round(m, 2) for m in r['reacquire_block_ms']]} ms host clock "
            f"({card})")
    log(f"[stream] launches over both runs {launches}")
    for h in held:
        rel = (f" (rel {h['max_rel_err']:.3g})" if "max_rel_err" in h
               else ", bit-identical")
        log(f"[stream] {h['run']} run, {h['program']} block: {h['kernel']} at "
            f"the engine's operands {h['shape']} against its twin, max "
            f"|kernel - twin| {h['max_abs_err']:.4g}{rel}")
    thr = {}
    for dtype in ("float32", "int8"):
        msps, ms, blocks = stream_throughput(x, dev, dtype)
        tags = [b["tag"] for b in blocks]
        wait = statistics.mean(b["device_wait_ms"] for b in blocks)
        life = statistics.mean(b["host_ms"] for b in blocks)
        thr[dtype] = dict(msamples_s=msps, ms_per_block=ms, tags=tags,
                          device_wait_ms=wait, lifecycle_ms=life)
        log(f"[stream] throughput {dtype}: {STREAM_TIMED_BLOCKS} blocks "
            f"{tags.count('steady')} steady, {ms:.3f} ms/block host clock = "
            f"{msps:.1f} Msamples/s; per block {wait:.3f} ms waiting on the "
            f"result fetch, {life:.3f} ms lifecycle, the rest append, slide "
            f"and launch ({card})")
    four, grid = impaired_feed(x, dev)
    twins = stream_twin_checks(four, grid, dev)
    log(f"[stream] card vs cpu twins, 4 ch (clean, 2 x AWGN 2000, gap burst): "
        f"tuple streams equal ({twins['tuples']} tuples); reacquire p0 "
        f"{twins['reacquire_p0']} burst_only {twins['burst_only']}, retime "
        f"delta {twins['retime_delta']}; max |card - cpu| freq_offset "
        f"{twins['reacquire_freq_offset']:.3g} Hz, frac "
        f"{max(twins['reacquire_frac'], twins['retime_frac']):.3g}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[stream] peak memory {peak / 2**30:.2f} GiB ({card})")
    return dict(runs=runs, launches=launches, held=held, throughput=thr,
                twins=twins, peak_bytes=peak)


def strict_launches(sd) -> list:
    """Run every predicted launch of the pipelined engine `sd` (window
    complete -> predicted program queued, _launch_predicted) under
    torch.cuda.set_sync_debug_mode("error"): a synchronizing CUDA call
    there raises.  Returns [launches checked], counting as they run."""
    import torch
    checked = [0]
    launch = sd._launch_predicted

    def strict(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = launch(*a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked[0] += 1
        return out
    sd._launch_predicted = strict
    return checked


def agc_twin_feed(x, dev):
    """(4, N) complex64 on `dev` for the AGC card-vs-CPU check: the main
    path's stream clean, in AWGN (sigma 2000 per component), at
    MODES_WEAK_GAIN, and stepping to MODES_WEAK_GAIN after 9 frames."""
    import torch
    g = torch.Generator(device=dev).manual_seed(STREAM_GAP_SEEDS[0])
    noise = 2000.0 * torch.complex(
        torch.randn(x.shape[1], generator=g, device=dev),
        torch.randn(x.shape[1], generator=g, device=dev))
    step = torch.ones(x.shape[1], device=dev)
    step[9 * SPF:] = MODES_WEAK_GAIN
    return torch.stack([x[0], x[1] + noise, x[2] * MODES_WEAK_GAIN,
                        x[3] * step])


def serve_eager(x, dev):
    """opv-modem --fast's engine (1 channel, block_frames 1, eager) and the
    window-gated one on channel 1 of the main path's stream, fed in
    frame-sized chunks.  Returns {eager: (tuples, per-feed tuple counts,
    per-feed host ms)} for eager False and True."""
    import torch
    from opv_tpu_torch.stream import LockedStreamDemodulator
    s = x[1:2]
    runs = {}
    for eager in (False, True):
        sd = LockedStreamDemodulator(1, block_frames=1, eager=eager,
                                     device=dev)
        out, counts, ms = [], [], []
        for off in range(0, s.shape[1], SPF):
            t0 = time.perf_counter()
            got = sd.feed(s[:, off:off + SPF])
            ms.append((time.perf_counter() - t0) * 1e3)
            out += got
            counts.append(len(got))
        out += sd.flush()
        torch.cuda.synchronize(dev)
        runs[eager] = (out, counts, ms)
    return runs


def phase_modes(x, frames, delays, dev, card):
    """The engine's other modes on the card: pipelined (float32, int8 with
    AGC), its launch free of synchronization, the synchronous/pipelined
    A/B, eager serving, hunt_stride 2 against 1, and the AGC path against
    the CPU twins."""
    import torch
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.stream import LockedStreamDemodulator
    feed, want = stream_feed(x, frames, delays, dev)
    agc_feed = feed.clone()
    agc_feed[MODES_WEAK] *= MODES_WEAK_GAIN
    runs = {"float32": ("float32", feed), "int8_agc": ("int8", agc_feed)}
    # 1. pipelined engines: the phase's counted run
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    piped = {}
    for name, (dtype, f) in runs.items():
        piped[name] = drive_stream(f, dev, dtype, agc=True, pipeline=True)
    launches = registry.launch_counts()
    need = ("viterbi_r4", "symbol_soft[float32]", "symbol_soft[int8]")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"a kernel of the pipelined path never "
                             f"launched: {launches}")
    held = []
    for name, (out, sd, per_call, kept) in piped.items():
        held += hold_stream_kernels(kept, f"pipelined {name}")
        if name == "int8_agc":
            # the int8 steady K3 call, held above, took per-channel steps
            resc = kept[("steady", "soft")][2]
            weak_max = float(resc[MODES_WEAK].max())
            others = float(resc[:MODES_WEAK.start].min())
            if not weak_max < others:
                raise AssertionError(f"int8 AGC steady K3: resc of the weak "
                                     f"channels {resc[MODES_WEAK].tolist()} "
                                     "not below the others'")
            next(h for h in held[-4:] if h["program"] == "steady"
                 and h["kernel"].startswith("symbol_soft")).update(
                     resc_weak_max=weak_max, resc_others_min=others)
            weak = sd._scale_np[MODES_WEAK]
            if not (weak < 1.0).all():
                raise AssertionError(f"weak channels' AGC step {weak}")
        kept.clear()
        check_stream(out, want, f"pipelined {name}")
        dtype, f = runs[name]
        sync, sd_s, _, _ = drive_stream(f, dev, dtype, spy=False, agc=True)
        same_stream(out, sync, f"pipelined {name} vs synchronous")
        for k in ("decoded", "perfect", "reacquisitions"):
            if getattr(sd, k) != getattr(sd_s, k):
                raise AssertionError(f"pipelined {name}: {k} {getattr(sd, k)}"
                                     f" against {getattr(sd_s, k)}")
        piped[name] = dict(tuples=len(out), reacquisitions=sd.reacquisitions,
                           blocks=sd.stats()["blocks_by_program"],
                           weak_step=[float(v) for v in
                                      sd._scale_np[MODES_WEAK]])
        log(f"[modes] pipelined {name}: {sum(len(w) for w in want)} "
            f"transmitted frames once, byte-exact, metric 0, at their "
            f"positions; {len(out)} tuples equal to the synchronous "
            f"engine's; re-acquisitions {sd.reacquisitions}; blocks "
            f"{piped[name]['blocks']}"
            + (f"; weak channels' step {weak.min():.4f}-{weak.max():.4f}"
               if name == "int8_agc" else ""))
    log(f"[modes] launches over both pipelined runs {launches}")
    for h in held:
        extra = (f"; resc weak <= {h['resc_weak_max']:.4g} < others >= "
                 f"{h['resc_others_min']:.4g}" if "resc_weak_max" in h else "")
        rel = (f" (rel {h['max_rel_err']:.3g})" if "max_rel_err" in h
               else ", bit-identical")
        log(f"[modes] {h['run']} run, {h['program']} block: {h['kernel']} at "
            f"the engine's operands {h['shape']} against its twin, max "
            f"|kernel - twin| {h['max_abs_err']:.4g}{rel}{extra}")
    # 2-3. synchronous against pipelined; a third arm runs every timed
    # pipelined launch under the sync-debug check, whose own cost would
    # otherwise confound the A/B
    ab = {}
    arms = (("synchronous", False, False), ("pipelined", True, False),
            ("pipelined, sync-debug check", True, True))
    for dtype in ("float32", "int8"):
        for alt in range(MODES_ALTERNATIONS):
            for arm, pipe, strict in arms:
                msps, ms, blocks = stream_throughput(
                    x, dev, dtype, strict=strict, agc=True, pipeline=pipe)
                rec = dict(msamples_s=msps, ms_per_block=ms,
                           device_wait_ms=statistics.mean(
                               b["device_wait_ms"] for b in blocks),
                           lifecycle_ms=statistics.mean(
                               b["host_ms"] for b in blocks),
                           steady=sum(b["tag"] == "steady" for b in blocks))
                key = f"{dtype}{'_agc' if dtype == 'int8' else ''} {arm}"
                ab.setdefault(key, []).append(rec)
                log(f"[modes] A/B {key} #{alt + 1}: {ms:.3f} ms/block = "
                    f"{msps:.1f} Msamples/s; per block "
                    f"{rec['device_wait_ms']:.3f} ms waiting on the results, "
                    f"{rec['lifecycle_ms']:.3f} ms lifecycle; "
                    f"{rec['steady']}/{STREAM_TIMED_BLOCKS} steady ({card})")
    log(f"[modes] no synchronizing call in {2 * MODES_ALTERNATIONS} x "
        f"{STREAM_TIMED_BLOCKS} timed pipelined launches under "
        f"set_sync_debug_mode('error')")
    # 4. eager serving at opv-modem --fast's configuration
    served = serve_eager(x, dev)
    same_stream(served[True][0], served[False][0], "eager vs window-gated")
    cb, ce = np.cumsum(served[False][1]), np.cumsum(served[True][1])
    first = int(np.argmax(ce > 0))
    if not (ce[first:] - cb[first:] == 1).all():
        raise AssertionError(f"eager lead: {served[True][1]} against "
                             f"{served[False][1]}")
    eager = {str(k): dict(tuples=len(v[0]),
                          p50_ms=float(np.percentile(v[2], 50)),
                          p95_ms=float(np.percentile(v[2], 95)))
             for k, v in served.items()}
    log(f"[modes] eager, 1 ch, block_frames 1, {len(served[True][1])} "
        f"frame-sized feeds: {len(served[True][0])} tuples equal to the "
        f"window-gated engine's, one frame ahead from feed {first}; host ms "
        f"per feed p50 {eager['True']['p50_ms']:.3f} p95 "
        f"{eager['True']['p95_ms']:.3f} (window-gated p50 "
        f"{eager['False']['p50_ms']:.3f} p95 {eager['False']['p95_ms']:.3f}) "
        f"({card})")
    # 5. hunt_stride 2 against 1 on the stream feed
    hunts = {}
    truth = [{bytes(f.cpu().numpy()) for f, _ in w} for w in want]
    for hs in (1, 2):
        out, sd, per_call, _ = drive_stream(feed, dev, "float32", spy=False,
                                            hunt_stride=hs)
        check_stream(out, want, f"hunt_stride {hs}")
        true = sorted((r[0], r[1], r[4]) for r in out if r[1] in truth[r[0]])
        hunts[hs] = (true, [ms for tags, ms in per_call
                            if tags == ["reacquire"]], sd.reacquisitions)
    if hunts[1][0] != hunts[2][0]:
        raise AssertionError("hunt_stride 2 recovered other true frames or "
                             "positions than hunt_stride 1")
    log(f"[modes] hunt_stride 2 vs 1: the same {len(hunts[1][0])} true "
        f"frames at the same positions; re-acquire blocks "
        f"{[round(m, 2) for m in hunts[2][1]]} vs "
        f"{[round(m, 2) for m in hunts[1][1]]} ms host clock; "
        f"re-acquisitions {hunts[2][2]} vs {hunts[1][2]} ({card})")
    # 6. the AGC path, pipelined, card against the CPU twins
    four = agc_twin_feed(x, dev)
    cpu = torch.device("cpu")
    agc_runs = []
    for d in (dev, cpu):
        sd = LockedStreamDemodulator(4, block_frames=STREAM_BF, dtype="int8",
                                     pipeline=True, device=d)
        sd._AGC_BLOCKS = MODES_AGC_BLOCKS
        src, out = four.to(d), []
        for off in range(0, src.shape[1], STREAM_TWIN_CHUNK):
            out += sd.feed(src[:, off:off + STREAM_TWIN_CHUNK])
        agc_runs.append((out + sd.flush(), sd._scale_np.copy()))
    same_stream(agc_runs[0][0], agc_runs[1][0], "pipelined int8 AGC card vs cpu")
    if not np.array_equal(agc_runs[0][1], agc_runs[1][1]):
        raise AssertionError(f"AGC steps card {agc_runs[0][1]} cpu "
                             f"{agc_runs[1][1]}")
    log(f"[modes] pipelined int8 AGC, 4 ch (clean, AWGN 2000, weak, level "
        f"step), _AGC_BLOCKS {MODES_AGC_BLOCKS}: card tuples equal the CPU "
        f"twins' ({len(agc_runs[0][0])} tuples), steps {agc_runs[0][1]}")
    return dict(launches=launches, pipelined=piped, held=held, ab=ab,
                eager=eager, hunt_stride={hs: dict(true_frames=len(v[0]),
                                                   reacquire_block_ms=v[1],
                                                   reacquisitions=v[2])
                                          for hs, v in hunts.items()},
                agc_twin=dict(tuples=len(agc_runs[0][0]),
                              steps=agc_runs[0][1].tolist()))


def wire_bytes(x) -> bytes:
    """(C, N) complex on the card -> the int16 wire bytes of opv-demod
    --channels C (I0 Q0 I1 Q1 ... per sample instant), rounded half to
    even and clipped to int16."""
    import torch
    pairs = torch.view_as_real(x.to(torch.complex64))
    q = torch.clamp(torch.round(pairs), -32768, 32767).to(torch.int16)
    return q.transpose(0, 1).contiguous().cpu().numpy().tobytes()


def repo_root():
    return pathlib.Path(__file__).resolve().parent


def golden(name: str) -> bytes:
    return (repo_root() / "tests" / "golden" / name).read_bytes()


def tx_cpu(frames_u8: np.ndarray, exact: bool = False) -> bytes:
    """The port's TX of (F, 134) frames on the CPU as one stream, as wire
    bytes (no flush)."""
    import torch
    from opv_tpu_torch.core.framing import encode_frame
    from opv_tpu_torch.tx.modulator import modulate_frames
    iq, _ = modulate_frames(encode_frame(torch.tensor(frames_u8)),
                            exact=exact)
    return iq.numpy().astype("<i2").tobytes()


def cli_mod(dev, card, fp64_ops_per_s: float):
    """opv_mod in this process on the card, and the phase_track kernel
    against its twin."""
    import torch
    from opv_tpu_torch.cli import opv_mod
    from opv_tpu_torch.ops import phase_track as pt
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.tx import modulator
    registry.reset_launch_counts()
    runs = {"bert3": (["-S", "W5NYV", "-B", "3"], b"", golden("bert3.iq")),
            "raw3": (["-R"], golden("raw3.bin"), golden("raw3.iq"))}
    for name, (argv, stdin, want) in runs.items():
        rc, out, err = run_main(opv_mod.main, argv, stdin)
        if rc != 0 or out != want:
            a = np.frombuffer(out[:len(want)], "<i2").reshape(-1, 2)
            b = np.frombuffer(want[:len(out)], "<i2").reshape(-1, 2)
            bad = np.nonzero((a != b).any(1))[0]
            raise AssertionError(
                f"[cli] opv_mod exact {name} on the card: rc {rc}, "
                f"{len(out)} bytes against {len(want)}, {len(bad)} samples "
                f"differ, first {bad[:8].tolist()}: card "
                f"{a[bad[:4]].tolist()} reference {b[bad[:4]].tolist()}; "
                f"{err[-500:]}")
    launches = registry.launch_counts()
    # one launch for -B 3 (one batch), one per frame for -R
    if launches["phase_track"] != 1 + 3:
        raise AssertionError(f"opv_mod exact launched phase_track "
                             f"{launches['phase_track']} times, want 4")
    raw3 = np.frombuffer(golden("raw3.bin"), np.uint8).reshape(-1, 134)
    rc, out, _ = run_main(opv_mod.main, ["-R", "--fast"], golden("raw3.bin"))
    want = tx_cpu(raw3) + bytes(4000 * 4)
    if rc != 0 or out != want:
        raise AssertionError("[cli] opv_mod --fast -R on the card differs "
                             "from the fast TX on the CPU")
    # the kernel against its twin over bert3's 260,160 samples
    n = 3 * SPF
    incs = (modulator._INC1, modulator._INC2)
    ph0 = torch.zeros(2, dtype=torch.float64, device=dev)
    got, got_f = pt.phase_track_cuda(ph0, incs, n)
    t0 = time.perf_counter()
    ref, ref_f = pt.phase_track_reference(ph0.cpu(), incs, n)
    twin_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(got.cpu(), ref) and torch.equal(got_f.cpu(), ref_f)):
        bad = torch.nonzero((got.cpu() != ref).any(0))[:8, 0].tolist()
        raise AssertionError(f"phase_track kernel != twin at samples {bad}")
    ms = cuda_ms(lambda: pt.phase_track_cuda(ph0, incs, n), CLI_TRACK_REPS)
    wraps = int((ref.diff(dim=1).abs() > np.pi).sum())
    nbytes = 2 * 8 + 2 * n * 8 + 2 * 8
    # per tone and sample: the add and the two wrap compares, plus the
    # wrap's add where this run's phases wrapped
    bound_ms, bound_by = bound(nbytes, 2 * n * 3 + wraps, fp64_ops_per_s)
    # the whole exact TX of bert3's frames, on the card and on the CPU
    from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
    enc = encode_frame(torch.from_numpy(build_bert_frame(
        "W5NYV", frame_num=np.arange(3))))
    enc_d = enc.to(dev)
    tx_ms = {}
    for where, e in (("card", enc_d), ("cpu", enc)):
        modulator.modulate_frames(e, exact=True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        modulator.modulate_frames(e, exact=True)
        torch.cuda.synchronize(dev)
        tx_ms[where] = (time.perf_counter() - t0) * 1e3 / 3
    log(f"[cli] opv_mod exact on the card: bert3 and raw3 byte-equal to the "
        f"reference captures; --fast -R equal to the CPU's fast TX; "
        f"phase_track launches {launches['phase_track']}")
    log(f"[cli] phase_track: kernel bit-identical to the twin over {n} "
        f"samples x 2 tones ({wraps} wraps); kernel {ms:.3f} ms = "
        f"{ms / 3:.3f} ms per frame, twin {twin_ms:.1f} ms = "
        f"{twin_ms / 3:.1f} ms per frame (host); bound {bound_ms:.5f} ms "
        f"({bound_by}); exact TX per 40 ms frame: card {tx_ms['card']:.2f} "
        f"ms, cpu {tx_ms['cpu']:.1f} ms (host clock; {card})")
    track_err = max((got.cpu() - ref).abs().max().item(),
                    (got_f.cpu() - ref_f).abs().max().item())
    kernel = dict(ms=ms, plain_ms=twin_ms, max_abs_err=track_err,
                  bound_ms=bound_ms,
                  bound_by=bound_by, roofline=bound_ms / ms, library_ms=None)
    return launches, kernel, dict(track_ms_per_frame=ms / 3,
                                  twin_ms_per_frame=twin_ms / 3,
                                  exact_tx_ms_per_frame=tx_ms)


def engine_on_reads(wire: bytes, c: int, read_bytes: int, dev, buf: str,
                    f32: bool = False):
    """The engine opv_demod -s --fast --channels c --buf `buf` --metrics
    builds, fed the CLI's reads of `wire` outside the CLI: its tuples.
    f32: each read as float32 pairs (the JAX CLI's framing) instead of the
    int16 view."""
    from opv_tpu_torch.io.iq import iq_bytes_to_i16_pairs
    from opv_tpu_torch.stream import LockedStreamDemodulator
    sd = LockedStreamDemodulator(channels=c, pipeline=True, dtype=buf,
                                 block_frames=STREAM_BF, timing=True,
                                 device=dev)
    out, carry, quantum = [], b"", 4 * c
    for off in range(0, len(wire), read_bytes):
        chunk = carry + wire[off:off + read_bytes]
        carry = chunk[len(chunk) - len(chunk) % quantum:]
        pairs = iq_bytes_to_i16_pairs(chunk, channels=c)
        out += sd.feed(np.ascontiguousarray(pairs, np.float32) if f32
                       else pairs)
    return out + sd.flush()


def cli_demod(x, frames, delays, dev, card):
    """opv_demod -s --fast -r -q --channels 64 in this process on the stream
    phase's feed as wire bytes, float32 and int8 rows.  float32 must emit
    every transmitted frame of the clean channels once; int8 must emit
    what its engine emits on the same reads, and the frames it loses are
    counted (ROADMAP queue 3: AGC primes a channel that is silent on the
    first read at the 1e-6 floor)."""
    import torch
    from opv_tpu_torch.cli import opv_demod
    from opv_tpu_torch.ops import registry
    feed, want = stream_feed(x, frames, delays, dev)
    c, n = feed.shape
    wire = wire_bytes(feed)
    del feed
    want = [Counter(bytes(f.cpu().numpy()) for f, _ in chan) for chan in want]
    expect = sum(want, Counter())
    n_want = sum(expect.values())
    metrics_dir = pathlib.Path("build/chip_smoke")
    metrics_dir.mkdir(parents=True, exist_ok=True)
    runs, launches = {}, {}
    read_bytes = opv_demod.READ_BYTES
    # the CLI's 1 MiB reads on both row types, then float32 with reads
    # CLI_BIG_READ times larger: what the framing costs (not counted)
    for buf, scale in (("float32", 1), ("int8", 1), ("float32", CLI_BIG_READ)):
        name = buf if scale == 1 else f"{buf}, {scale} MiB reads"
        path = metrics_dir / f"cli_metrics_{buf}_{scale}.jsonl"
        registry.reset_launch_counts()
        opv_demod.READ_BYTES = read_bytes * scale
        t0 = time.perf_counter()
        try:
            rc, out, err = run_main(opv_demod.main, [
                "-s", "--fast", "-r", "-q", "--channels", str(c), "--buf",
                buf, "--metrics", str(path)], wire)
            torch.cuda.synchronize(dev)
        finally:
            opv_demod.READ_BYTES = read_bytes
        dt = time.perf_counter() - t0
        counts = registry.launch_counts()
        if scale == 1:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        got = Counter(out[i:i + 134] for i in range(0, len(out), 134))
        extra = sum(k for b, k in got.items() if b not in expect)
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        final = lines[-1]
        if rc != 0 or len(out) % 134:
            raise AssertionError(f"[cli] opv_demod {name}: rc {rc}, "
                                 f"{len(out)} bytes; {err[-500:]}")
        lost = {}
        if buf == "int8":
            ref = engine_on_reads(wire, c, read_bytes * scale, dev, buf)
            if out != b"".join(r[1] for r in ref):
                raise AssertionError(
                    f"[cli] opv_demod {name}: {len(out) // 134} frames, not "
                    f"the {len(ref)} its engine emits on the same reads")
            # the reads as float32 pairs, as the JAX CLI feeds them
            same_stream(engine_on_reads(wire, c, read_bytes * scale, dev,
                                        buf, f32=True), ref,
                        f"opv_demod {name} engine: float32 pairs vs int16")
            for ch, w in enumerate(want):
                miss = w - Counter(r[1] for r in ref if r[0] == ch)
                if miss:
                    lost[ch] = sum(miss.values())
            held = (f"== its engine on the same reads, {len(ref)} frames, "
                    f"and == the engine fed them as float32 pairs")
        else:
            wrong = {b[:12].hex(): (got.get(b, 0), k)
                     for b, k in expect.items() if got.get(b, 0) != k}
            if wrong or extra > (c - STREAM_CLEAN) * STREAM_GAP_FRAMES:
                raise AssertionError(
                    f"[cli] opv_demod {name}: frames emitted (got, want) "
                    f"{list(wrong.items())[:6]}; {extra} frames not "
                    f"transmitted")
            held = f"{n_want}/{n_want} transmitted frames emitted once"
        if not (final.get("final") and final["decoded"] == len(out) // 134
                and final["channels"] == c):
            raise AssertionError(f"[cli] opv_demod {name}: final metrics "
                                 f"{final} against {len(out) // 134} frames")
        need = ["viterbi_r4", f"symbol_soft[{buf}]", "symbol_soft[float32]"]
        if min(counts[k] for k in need) <= 0:
            raise AssertionError(f"[cli] opv_demod {name}: a kernel never "
                                 f"launched: {counts}")
        feeds = -(-len(wire) // (read_bytes * scale))
        msps = c * n / dt / 1e6
        runs[name] = dict(seconds=dt, msamples_s=msps,
                          x_real_time=msps / (c * REAL_TIME_MSPS),
                          feeds=feeds, ms_per_feed=dt * 1e3 / feeds,
                          frames=len(out) // 134, not_transmitted=extra,
                          lost_by_channel=lost,
                          metrics_lines=len(lines), launches=counts,
                          blocks=final.get("blocks_by_program"))
        log(f"[cli] opv_demod -s --fast -r -q --channels {c} --buf {name}: "
            f"{held}, byte-exact (+{extra} flywheel frames over the gaps); "
            f"transmitted frames lost {sum(lost.values())} of {n_want} "
            f"(by channel {lost}); final metrics line decoded "
            f"{final['decoded']}; {c} x {n} samples in {dt:.3f} s host clock "
            f"= {msps:.1f} Msamples/s = {runs[name]['x_real_time']:.2f} x "
            f"real time; {feeds} reads of {scale} MiB, "
            f"{dt * 1e3 / feeds:.3f} ms each; blocks "
            f"{final.get('blocks_by_program')}; launches {counts} ({card})")
    # the wire-to-pairs view of every read alone, at both sizes
    from opv_tpu_torch.io.iq import iq_bytes_to_i16_pairs
    for scale in (1, CLI_BIG_READ):
        step = read_bytes * scale
        t0 = time.perf_counter()
        for off in range(0, len(wire), step):
            iq_bytes_to_i16_pairs(wire[off:off + step], channels=c)
        conv_s = time.perf_counter() - t0
        runs[f"conversion_s_{scale}_mib"] = conv_s
        log(f"[cli] iq_bytes_to_i16_pairs alone over the {scale} MiB reads: "
            f"{conv_s:.3f} s, {conv_s * 1e3 / -(-len(wire) // step):.3f} ms "
            f"per read (host clock; {card})")
    return launches, runs


def start_modem(argv):
    """opv_modem as a process on a fresh port, once it listens; stdout is
    piped.  Returns (process, port)."""
    import select
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m",
                             "opv_tpu_torch.cli.opv_modem", "-p", str(port),
                             *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, cwd=repo_root())
    seen, deadline = b"", time.time() + CLI_START_S
    while b"Listening" not in seen and proc.poll() is None \
            and select.select([proc.stderr], [], [],
                              max(0.0, deadline - time.time()))[0]:
        seen += proc.stderr.readline()
    if b"Listening" not in seen:
        stop(proc)
        raise AssertionError(f"opv_modem {argv} did not listen: "
                             f"{seen[-1000:]!r}")
    return proc, port


def stop(proc) -> bytes:
    """SIGTERM, then wait (kill after 60 s); the rest of stdout."""
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return out or b""


def cli_processes(x, card):
    """opv_demod at 1 channel with no --device, and opv_modem -R --fast,
    -l --fast and -t -o, each as its own process."""
    import socket
    import tempfile
    from opv_tpu_torch.core.framing import build_bert_frame
    # 1. the default device is the card: channel 0 of the main stream
    sent = b"".join(bytes(f) for f in build_bert_frame(
        "W5NYV", frame_num=np.arange(FRAMES)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "opv_tpu_torch.cli.opv_demod",
                        "-s", "--fast", "-r", "-q"], input=wire_bytes(x[:1]),
                       capture_output=True, timeout=300, cwd=repo_root())
    demod_s = time.perf_counter() - t0
    if r.returncode != 0 or r.stdout != sent:
        raise AssertionError(f"[cli] opv_demod process, default device: rc "
                             f"{r.returncode}, {len(r.stdout)} bytes against "
                             f"{len(sent)}; {r.stderr.decode()[-800:]}")
    # 2. -R --fast: bert3's frames over UDP
    listener = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    listener.bind(("127.0.0.1", 0))
    listener.settimeout(60)
    r = subprocess.run([sys.executable, "-m", "opv_tpu_torch.cli.opv_modem",
                        "-R", "--fast", "-q", "-r",
                        str(listener.getsockname()[1])],
                       input=golden("bert3.iq"), capture_output=True,
                       timeout=300, cwd=repo_root())
    try:
        got = [listener.recvfrom(4096)[0] for _ in range(3)]
    finally:
        listener.close()
    if r.returncode != 0 or b"".join(got) != golden("bert3.frames"):
        raise AssertionError(f"[cli] opv_modem -R --fast: rc {r.returncode},"
                             f" frames {[g[:8].hex() for g in got]}")
    # 3. -l --fast: frames at a frame's pacing, echo latency; a warm-up
    # burst first (the server's first frames pay for loading the CUDA
    # kernels and for acquisition), then the timed frames
    frames = [bytes(f) for f in build_bert_frame(
        "W5NYV", frame_num=np.arange(CLI_ECHO_WARM + CLI_ECHO_FRAMES))]
    proc, port = start_modem(["-l", "--fast"])
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    sent_at, back = {}, []

    def paced(batch, until):
        """Send `batch` a frame's time apart, collecting echoes, then wait
        until `until` echoes are back."""
        s.settimeout(0.002)
        t_next = time.perf_counter()
        for f in batch:
            sent_at[f] = time.perf_counter()
            s.sendto(f, ("127.0.0.1", port))
            t_next += CLI_PACING_S
            while time.perf_counter() < t_next:
                try:
                    back.append((s.recvfrom(4096)[0], time.perf_counter()))
                except socket.timeout:
                    pass
        s.settimeout(60)
        while len(back) < until:
            back.append((s.recvfrom(4096)[0], time.perf_counter()))
    try:
        paced(frames[:CLI_ECHO_WARM], CLI_ECHO_WARM - 1)
        paced(frames[CLI_ECHO_WARM:], len(frames) - 1)
    finally:
        stop(proc)
        s.close()
    if [b for b, _ in back] != frames[:len(back)]:
        raise AssertionError("[cli] opv_modem -l --fast: echoed frames are "
                             "not the frames sent, in order")
    cold = (back[0][1] - sent_at[back[0][0]]) * 1e3
    lat = sorted((t - sent_at[b]) * 1e3 for b, t in back[CLI_ECHO_WARM:])
    p50, p95 = lat[len(lat) // 2], lat[int(0.95 * (len(lat) - 1))]
    # 4. -t -o: stdout, tee and the exact modulation of two frames
    with tempfile.TemporaryDirectory() as tmp:
        tee = f"{tmp}/tee.iq"
        proc, port = start_modem(["-t", "-o", tee])
        want = 2 * SPF * 4
        out = b""
        try:
            tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for f in frames[:2]:
                tx.sendto(f, ("127.0.0.1", port))
            tx.close()
            deadline = time.time() + 60
            while len(out) < want and time.time() < deadline:
                out += proc.stdout.read1(1 << 20)
        finally:
            out += stop(proc)
        with open(tee, "rb") as fh:
            tee_bytes = fh.read()
    exact = tx_cpu(np.frombuffer(b"".join(frames[:2]), np.uint8
                                      ).reshape(2, 134), exact=True)
    if out != exact or tee_bytes != out + bytes(4000 * 4):
        raise AssertionError(f"[cli] opv_modem -t -o: stdout {len(out)} bytes "
                             f"== exact modulation {out == exact}, tee "
                             f"{len(tee_bytes)} bytes == stdout + flush "
                             f"{tee_bytes == out + bytes(16000)}")
    log(f"[cli] processes: opv_demod -s --fast -r -q with no --device decoded "
        f"{FRAMES}/{FRAMES} frames byte-exact in {demod_s:.1f} s (process "
        f"start included); opv_modem -R --fast delivered bert3's 3 frames; "
        f"-l --fast echoed {len(back)}/{len(frames)} frames sent every "
        f"{CLI_PACING_S * 1e3:.0f} ms byte-equal: the first {cold:.1f} ms "
        f"after it was sent, then over {len(lat)} frames after "
        f"{CLI_ECHO_WARM} of warm-up echo latency p50 {p50:.2f} ms p95 "
        f"{p95:.2f} ms (host clock); -t -o stdout == tee == the exact "
        f"modulation of 2 frames ({card})")
    return dict(default_device_demod_s=demod_s, echo_frames=len(back),
                echo_first_ms=cold, echo_p50_ms=p50, echo_p95_ms=p95,
                echo_ms=lat)


def phase_cli(x, frames, delays, dev, card, fp64_ops_per_s: float):
    """The port's CLIs on the card (phase 9)."""
    t0 = time.perf_counter()
    mod_launches, kernel, tx = cli_mod(dev, card, fp64_ops_per_s)
    demod_launches, demod = cli_demod(x, frames, delays, dev, card)
    procs = cli_processes(x, card)
    launches = {k: mod_launches[k] + demod_launches[k] for k in mod_launches}
    log(f"[cli] launches over the in-process runs {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, mod_launches=mod_launches,
                phase_track=kernel, tx=tx, demod=demod, processes=procs)


def phase_profile(state, card, out_dir="build/chip_smoke"):
    """Device time by op over three steady blocks per buffer type."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from opv_tpu_torch.rx.locked import rx_locked_steady
    rows_f, rows_q, p0, foff, frac = state
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    for name, rows in (("f32", rows_f), ("int8", rows_q)):
        def block():
            return rx_locked_steady(rows, p0, foff, FRAMES, frac=frac)
        block()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], acc_events=True) as prof:
            start.record()
            for _ in range(3):
                block()
            end.record()
            torch.cuda.synchronize()
        wall_us = start.elapsed_time(end) * 1e3
        # device-side events only: an aten op's own entry repeats the time
        # of the kernels it launched
        ops = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
        busy = sum(t for t, _, _ in ops)
        log(f"[profile] steady {name}: 3 blocks {wall_us / 1e3:.3f} ms, device "
            f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
            f"{sum(n for _, n, _ in ops) // 3} kernels/block ({card})")
        for t, n, key in ops[:12]:
            log(f"[profile]   {t / 3e3:8.4f} ms/block {n // 3:4d}x  {key[:90]}")
        prof.export_chrome_trace(str(pathlib.Path(out_dir)
                                     / f"steady_{name}_trace.json"))


def main() -> int:
    import torch
    card, int_ops_per_s = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    vit = phase_viterbi(dev, int_ops_per_s)
    x, frames, delays = synthesize(dev)
    soft = phase_soft(x, dev)
    launches, steady, peak, state = phase_main(x, frames, delays, dev, card)
    phase_profile(state, card)
    del state
    stream = phase_stream(x, frames, delays, dev, card)
    modes = phase_modes(x, frames, delays, dev, card)
    cli = phase_cli(x, frames, delays, dev, card, PEAK_OPS_PER_S["f64"])
    kernels = [
        dict(name="viterbi_r4", route="cuda", source="opv_tpu_torch/csrc/viterbi.cu",
             replaces="opv_tpu/ops/pallas/viterbi.py:256",
             launches=launches["viterbi_r4"], **vit[4]),
        dict(name="viterbi_r2", route="cuda", source="opv_tpu_torch/csrc/viterbi.cu",
             replaces="opv_tpu/ops/pallas/viterbi.py:145",
             launches=launches["viterbi_r2"], **vit[2]),
    ]
    for k in kernels:
        k["launches_stream"] = stream["launches"][k["name"]]
        k["launches_modes"] = modes["launches"][k["name"]]
        k["launches_cli"] = cli["launches"][k["name"]]
    # one kernel template, counted per row type where it launches
    for name, rows in (("f32", "float32"), ("int8", "int8")):
        key = f"symbol_soft[{rows}]"
        kernels.append(dict(
            name=key, route="cuda", source="opv_tpu_torch/csrc/symbol_soft.cu",
            replaces="opv_tpu/ops/pallas/correlate.py:37",
            launches=launches[key], launches_stream=stream["launches"][key],
            launches_modes=modes["launches"][key],
            launches_cli=cli["launches"][key], **soft[name]))
    kernels.append(dict(
        name="phase_track", route="cuda",
        source="opv_tpu_torch/csrc/phase_track.cu",
        replaces="opv_tpu/tx/modulator.py:188",
        launches=cli["mod_launches"]["phase_track"],
        launches_stream=stream["launches"]["phase_track"],
        launches_modes=modes["launches"]["phase_track"],
        launches_cli=cli["launches"]["phase_track"], **cli["phase_track"]))
    print(json.dumps({"kernels": kernels, "steady_ms": steady,
                      "stream": stream, "modes": modes, "cli": cli,
                      "peak_bytes": peak}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
