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
 10. wideband the wideband receiver (WidebandReceiver: polyphase
              channelizer + locked engine) on wideband-64: 64 channels x 12
              frames of their own stations at one digitizer rate, channel c
              from sample 2000 + 487 c, synthesized on the card (~69 M
              samples).  (a) channelize over one quantum, card against
              cpu, its ms and bound; (b) synchronous float32, block_frames
              4: fed a window, quanta, then flushed; its tuples against the
              same receiver on the cpu, and against the transmitted frames
              (each once at most, byte-exact, on its channel, one 86,720
              grid per channel; the frames lost to false locks before a
              channel's own start are counted, ROADMAP queue 3; at the
              level of (h) every frame must come out), the engine's first
              K3 and K1 call of each program held against the twins; (c)
              pipelined and (d) ragged chunks equal to (b), also at the
              level of (h); (e) int8 + AGC: synchronous and pipelined at
              the level of (h), every frame once, byte-exact; synchronous
              at full scale against the same receiver on the cpu, frames
              as (b); (f) the K = 4 signal of tests/test_wideband.py on
              the card against the cpu; (g) Msamples/s and the multiple
              of real time on a frame-periodic stream (float32 and int8 + AGC,
              synchronous and pipelined, and pipelined under
              set_sync_debug_mode("error")); (h) opv_demod -s --fast
              --wideband 64 -r -q in this process on (b)'s signal as int16
              wire bytes: its receiver's frames, Msamples/s
 11. tracking the reference-parity tracking receiver (float64 AFC/TED loop
              and sync state machine): (a) the track_symbols kernel against
              its twin on one chunk per channel of the golden captures
              bert3, cfo500, awgn10, awgn7, awgn8, dropout, drift (channel
              c: capture c % 7, from its CFO estimate) at C = 1 and 64:
              n_sym, samples_used and sym_valid equal, soft and the state
              within TRACK_RTOL; both instantiations of sync_scan
              (GivenSync: raw/norm given; SoftSync: the correlation as
              its input stage, on the view soft_cat[:, 2121:]) bit for
              bit on the card's soft, on stress inputs reaching every
              transition (sync_stress, soft_stress) and on
              SYNC_EDGE_CASES (tile edges, short rows, 133 channels, a
              whole capture, int32 carries, a view 8 bytes off 16); all
              timed against the chunk's 40 ms of air and their bounds,
              SoftSync beside the two-step route (torch's sync_correlate,
              then GivenSync); track_symbols' ms per chunk also as
              cycles a symbol (ms x the max SM clock, not a clock64
              count), the ptxas reports; track_symbols held against the
              twin on the edges of its sample ring (TRACK_EDGE_CASES: a
              whole-capture launch, caps of 64 and 100, a window clamped
              at cap - 64, 133 channels, a view at a storage offset);
              then rx/sync.py's two routes (sync_correlate + sync_scan,
              sync_correlate_scan) on one chunk at 64 channels, equal
              (the GivenSync path's launches are this run's);
              (b) rx_batch on the card: bert3.frames and raw3.bin byte for
              byte; StreamingDemodulator on the card: the nine golden
              checks of tests/test_streaming.py, every tuple equal to the
              same receiver on the host (run in worker processes); (c)
              tracking-64: MultiChannelTrackingDemodulator(channels=64)
              over the golden mix, channel c delayed by (c // 7) x 487
              zeros and padded to the longest, fed a chunk at a time: each
              channel equal to a single-channel StreamingDemodulator on the
              card, channels 0-6 the reference's frames; host ms per
              chunk, Msamples/s, the multiple of real time, the kernels'
              device ms and device kernels per chunk (torch.profiler),
              the port's kernels' launches per chunk, peak memory; (d)
              opv_demod batch -r -q (bert3, raw3) and -s -r -q (awgn8,
              dropout) in this process against the goldens, -s on bert3
              with the reference's five transition lines, and opv_modem -l
              without --fast as a process: echo p50/p95 beside phase 9's
              --fast numbers
 12. dense    the feed-forward dense receiver and the coherent
              demodulator: (a) rx_fast on smoke-64x20 (max_frames 22):
              every frame whose payload fits valid, byte-exact, at its
              sync start with metric 0 or one sample late (the sync apex's
              plateau); ms per call (CUDA events, median of 5), device ms
              by stage and by kernel (torch.profiler), peak memory; (b)
              MultiChannelDemodulator(64, block_frames 4) on the stream
              phase's feed: channels 0-55 every frame once, byte-exact,
              at its position (+-1); channels 56-63 (the gap bursts) on
              the card equal to the same receiver on the cpu given the
              card's CFO estimates (every block's slots held); host ms per
              block, Msamples/s, the multiple of real time, peak memory;
              (c) WidebandReceiver(engine="fast") at K = 64 on the wideband
              phase's carriers at the wire level: frames decoded of 768 and
              ms per quantum beside the locked engine on the same feed;
              on a K = 4 cut of those carriers the card equal to the cpu
              as in (b); (d) opv_demod --fast -r -q on bert3 and raw3 (the
              goldens) and opv_demod -c on bert3 (the reference's report,
              rc 1) in this process; the coherent loop's ms per symbol on
              the card against bert3's 0.122 s of air, its soft values
              against the cpu's; rx_fast's first Viterbi call and -c's
              SoftSync call held against the twins after the count
 13. precision the float32 tracking receiver (JAX's dtype="float32"): (a)
              track_symbols[float32] and both sync_scan[float32]
              instantiations against their twins at C = 1 and 64 on one
              chunk of the golden mix as complex64 (T1: n_sym,
              samples_used, sym_valid equal, soft and state within
              TRACK_F32_RTOL; T2 bit for bit), each timed in turns with
              its float64 instantiation on the same chunk; T1[float32] on
              TRACK_EDGE_CASES and TRACK_F32_EDGE_CASES (an odd cap, odd
              rows off 16 bytes), T2[float32] on the stress inputs (norms
              on float32's rounded 0.7) and SYNC_EDGE_CASES; the two sync
              routes at float32; (b) rx_batch(dtype="float32") and
              StreamingDemodulator(dtype="float32") on the card over the
              nine golden checks (and raw3): the streaming runs the
              reference's frames, rx_batch PRECISION_BATCH_GOLDENS', and
              both equal to the host's float32 run given the card's CFO
              estimate; (c) tracking-64 at float32:
              MultiChannelTrackingDemodulator(64, dtype="float32") on phase
              11's feed, each channel equal to its single-channel run at
              its CFO estimate, channels 0-6 the reference's frames; host
              ms per chunk, Msamples/s, multiple of real time, device ms by
              kernel (torch.profiler), peak memory, beside phase 11's
              float64 numbers of this run; (d) TestDivergentClocks' feed
              (300 ppm apart) through MultiChannelTrackingDemodulator(2) on
              the card at float64 and float32, equal to the host's given
              the card's CFO estimates; (e) smoke-64x20 as complex128
              (the JAX package's float64 path) through rx_locked,
              rx_locked_steady and rx_fast: every frame byte-exact, peak
              memory; then symbol_soft[float64] held against its twin on
              the steady block's operands (SOFT_F64_RTOL), its time, bytes
              bound and torch.bmm's float64 time
 14. mesh     the multi-device modes, on meshes naming the card several
              times (a shard per entry, each with its own tensors): (a)
              stream-64's feed (phase 7) through LockedStreamDemodulator(64,
              block_frames 4, mesh=('ch'=8)) and unsharded, synchronous and
              pipelined, float32 rows and int8 + AGC: the tuples equal, the
              transmitted frames once each (float32), the window one (8,
              window/40, 80) tensor per shard, K3/K1 launches per block of
              both, shard 0's first K3 and K1 call of each program held
              against the twins; ms per steady block on bench.py's cyclic
              feed, sharded against unsharded in turns, peak memory; (b)
              wideband-64 periodic (phase 10 (g)'s feed) through
              WidebandReceiver(64, mesh=('ch'=8)) and unsharded: the
              tuples equal, ms per quantum; (c) smoke-64x20's signal
              through rx_fast_sharded ('ch'=8) against rx_fast (frames
              equal, n the valid frames), its channel 0 through
              rx_time_sharded ('time'=4): every frame once, starts within
              one sample of its grid; (d) ShardedStreamDemodulator on a
              (ch=8, time=4) mesh over smoke-64x20's 64 channels in
              300,001-sample feeds: every frame once, byte-exact, at its
              position, and a mid-stream checkpoint resumed to the same
              tuples; (e) this script as two worker processes on the card
              (gloo): the (ch=2, time=2) grid decode and the grid stream
              (its 'time' axis across the processes) and the locked engine
              with 'ch' across the processes, each equal to its
              single-process run, both ranks the same tuples; (f)
              dryrun_multichip(8)
 15. the kernels JSON line (launches: the main path's, for phase_track the
     cli phase's opv_mod runs, for track_symbols and sync_scan[SoftSync]
     the tracking phase's (b)-(d), for sync_scan[GivenSync] its route's
     in (a); launches_stream: the stream phase's two runs;
     launches_modes: the two pipelined runs of the modes phase;
     launches_cli: the cli phase's in-process runs; launches_wideband: the
     wideband phase's runs (b)-(e); launches_tracking: the tracking
     phase's (b)-(d); launches_dense: the dense phase's runs (a)-(d)
     without its stage timings; launches_precision: the precision phase's
     (b)-(e); launches_mesh: the mesh phase's (a)-(d) and (f); the float32 instantiations of track_symbols and sync_scan
     and the float64 one of symbol_soft their own rows, launches from
     phase 13 (b)-(e), GivenSync's from its float32 route), the card line,
     then the result line
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
#: the same for float64 rows (the complex128 path, phase 13 (e)): float64
#: sums of 80 products in another order
SOFT_F64_RTOL = 1e-12
KERNEL_REPS = 20
#: published H100 SXM peaks (NVIDIA's H100 datasheet): HBM bytes/s, and
#: operations/s for float32 outside the tensor cores and for int8
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12,
                  # float64 outside the tensor cores (the same datasheet)
                  "f64": 34e12,
                  # float64 on the tensor cores (a DGEMM; the same datasheet)
                  "f64_tensor": 67e12}
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
#: the wideband phase (wideband-64): K channels, the engine's block, frames
#: per channel, channel c's lead WB_LEAD + WB_LEAD_STEP c channel samples
WB_K = 64
WB_BF = 4
WB_FRAMES = 12
WB_LEAD = 2000
WB_LEAD_STEP = 487
#: a frame that was not transmitted (a quiet channel's leakage, a false
#: lock's garbage) must have a metric above this (tests/test_wideband.py)
WB_LEAK_METRIC = 100
#: ... and its sync quality may differ by this between the card and the
#: cpu (float32 order; at most 2.63e-4 seen, on a false lock's garbage,
#: H100)
WB_GARBAGE_Q_TOL = 1e-3
#: each carrier's gain on the int16 wire of (h): K carriers at full scale
#: sum to at most 32767
WB_WIRE_GAIN = 32767.0 / (WB_K * 16383.0)
#: channelize on the card against the cpu: within this of max|y|
WB_Y_RTOL = 1e-5
WB_CHAN_REPS = 10
#: (d): ragged chunk sizes, numpy's generator from this seed
WB_RAGGED = (1_000_000, 9_000_000)
WB_RAGGED_SEED = 12
#: (g): the periodic stream's least period (frames), warm-up and timed
#: quanta; (h): the block opv_demod --wideband uses by default
WB_PERIOD_FRAMES = 8
WB_WARM_QUANTA = 5
WB_TIMED_QUANTA = 12
WB_CLI_BLOCK = 2
#: the tracking phase (the reference-parity receiver): channel c of its
#: feeds carries golden capture c % 7 of TRACK_CAPTURES; (c) delays channel
#: c by (c // 7) * TRACK_LEAD_STEP leading zero samples
TRACK_CAPTURES = ("bert3", "cfo500", "awgn10", "awgn7", "awgn8", "dropout",
                  "drift")
TRACK_CHANNELS = 64
TRACK_LEAD_STEP = 487
#: track_symbols on the card against its twin: soft and every state column
#: within TRACK_RTOL x max(1, max|twin|) (phases compared modulo 2 pi).
#: sincos and atan2 differ from the host's libm by an ulp or two and the
#: warp sums the 40 taps in another order; the loops are stable, so the
#: two trajectories stay ~1e-14 apart (the kernel's C++ run on the host
#: against the twin: 2.4e-15 of max|soft|); n_sym, samples_used and
#: sym_valid must be equal
TRACK_RTOL = 1e-9
#: the same at float32 (phase 13): float32 sums in another order and
#: sincosf/atan2f an ulp or two from the host's; the host twin against the
#: JAX package's float32 scan stays within 1.5e-6 of max|soft| over a whole
#: chunk, and mu within 4e-6 (tests/test_torch_tracking_f32.py)
TRACK_F32_RTOL = 1e-4
#: ... and the float32 state: each field within this x max(1, max|twin|),
#: prev_c1 and prev_c2 as complex values (their magnitude the scale).  The
#: LO phases are float32 accumulators, rounded at ulp(pi) = 2.4e-7 each
#: symbol and advanced at AFC offsets ~1e-4 Hz apart, so they walk apart
#: ~5e-5 rad over a chunk (the card against the twin, H100) and further
#: over a whole capture; prev_c carries that rotation at |c| ~ 6e5
TRACK_F32_STATE_RTOL = 1e-3
#: a frame's sync quality, card against cpu and one channel of (c) against
#: its single-channel run: within this (a ratio of sums of the soft values
#: above); bytes, metric and symbol index must be equal
TRACK_Q_TOL = 1e-9
TRACK_REPS = 5
#: launches a sync_scan time averages (device_ms)
SYNC_REPS = 50
#: phase 13 (precision): the float32 receivers on the card against the host
#: given the same CFO, sync quality within this (float32 ratios of sums the
#: two devices round apart, ~1e-6); frames, metrics, indices equal
PRECISION_Q_TOL = 1e-5
#: the golden checks whose captures the batch mode (rx_batch) reads as the
#: reference did: awgn7, awgn8 and drift are streaming captures whose
#: batch frames differ from theirs in both packages, at float64 too
PRECISION_BATCH_GOLDENS = (("bert3", "bert3.frames"),
                           ("cfo500", "cfo500.frames"),
                           ("awgn10", "awgn10.frames"),
                           ("dropout", "dropout.frames"),
                           ("cfo500", "cfo500_a01.frames"),
                           ("cfo500", "cfo500_o500.frames"),
                           ("raw3", "raw3.bin"))
#: the inputs of track_edge_case: the edges of the kernel's sample ring
TRACK_EDGE_CASES = ("whole capture", "cap 64", "cap 100", "clamp 1",
                    "clamp 2", "C=133", "storage offset")
#: and the float32 loop's own (complex64 rows of odd length and off 16
#: bytes: the wrapper pads them for the kernel's 16-byte bulk copies)
TRACK_F32_EDGE_CASES = ("odd cap", "odd rows")
#: the nine golden checks of tests/test_streaming.py: capture, the
#: reference's frames, StreamingDemodulator options
TRACK_GOLDENS = (("bert3", "bert3.frames", {}),
                 ("cfo500", "cfo500.frames", {}),
                 ("awgn10", "awgn10.frames", {}),
                 ("awgn7", "awgn7.frames", {}),
                 ("awgn8", "awgn8.frames", {}),
                 ("dropout", "dropout.frames", {}),
                 ("drift", "drift.frames", {}),
                 ("cfo500", "cfo500_a01.frames", {"afc_alpha": 0.01}),
                 ("cfo500", "cfo500_o500.frames", {"init_offset": 500.0}))
#: float64 operations per tap and symbol of track_symbols: three linear
#: interpolations (8 each), two LO arguments (2 each), six complex
#: multiply-adds (8 each) and two sincos (TRACK_SINCOS_OPS each); per
#: symbol: the 12-value warp reduction (5 adds each) and ~60 of scalar update
TRACK_SINCOS_OPS = 20
TRACK_OPS_PER_TAP = 3 * 8 + 2 * 2 + 6 * 8 + 2 * TRACK_SINCOS_OPS
TRACK_OPS_PER_SYMBOL = 40 * TRACK_OPS_PER_TAP + 12 * 5 + 60
#: int32 operations per symbol of sync_scan's state machine (adds,
#: compares, selects)
SYNC_OPS_PER_SYMBOL = 30
#: float64 operations per symbol of sync_scan's SoftSync input stage: 24
#: adds to raw, 24 to the energy, one division
SYNC_F64_OPS_PER_SYMBOL = 2 * 24 + 1
#: the dense phase: rx_fast's frame slots at smoke-64x20 (its 20 frames and
#: two spare) and its timed calls; MultiChannelDemodulator's block; the K
#: of the wideband cut held against the cpu
DENSE_MAX_FRAMES = 22
DENSE_REPS = 5
DENSE_BF = 4
DENSE_CUT_K = 4
#: rx_fast on the card against the cpu given the same CFO: sync quality
#: within DENSE_Q_TOL (float32 sums in another order); a start one sample
#: away only at a plateau tie of the MSK sync apex, where the raw
#: correlation of the two samples agrees within DENSE_PLATEAU_RTOL (a few
#: float32 ulps of a 24-term sum)
DENSE_Q_TOL = 1e-5
DENSE_PLATEAU_RTOL = 1e-6
#: a transmitted frame detected one sample late on that plateau: its
#: payload is read one sample off the symbol grid, and the last frame of a
#: transmission then takes a sample of the zero flush into its last symbol
#: (metric 1 in both packages); at its exact start the metric must be 0
DENSE_LATE_METRIC = 16
#: the coherent loop on the card against the cpu: soft values within
#: COHERENT_RTOL of max|soft| over the first COHERENT_SYMBOLS symbols of
#: bert3.  The loop is chaotic: rounding differences grow ~1e-14 -> 1e-8
#: over bert3's 6,604 symbols (cpu against the JAX package)
COHERENT_RTOL = 1e-9
COHERENT_SYMBOLS = 320
#: the reference binary's report of opv-demod -c < bert3.iq
#: (tests/test_coherent.py)
#: phase 14 (mesh): the 'ch' axis of the sharded engine, wideband receiver
#: and rx_fast_sharded; the 'time' axis of rx_time_sharded; the grid
#: stream's (ch, time) mesh and its feed size (straddling its windows); the
#: timed calls of (c); seconds a worker process of (e) may take
MESH_CH = 8
MESH_TIME = 4
MESH_GRID = (8, 4)
MESH_GRID_CHUNK = 300_001
MESH_REPS = 3
MESH_WORKER_TIMEOUT_S = 420
COHERENT_LINES = ("Estimated carrier offset: 1430.0 Hz",
                  "Demodulated 6604 symbols, final AFC offset: 2000.0 Hz",
                  "Summary: 0 frames (0 perfect, 0 errors)",
                  "Final state: HUNTING, AFC: 2000.0 Hz")


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


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (one warm-up first),
    with a ~25 ms sleep kernel ahead of the start event: the host queues
    every launch meanwhile, so a kernel shorter than its launch's host
    cost is timed on the device alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
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


def hold_soft(ops, nsym: int, what: str, rtol: float = SOFT_RTOL):
    """The soft-stage kernel against its twin on `ops` (rows, kern, resc,
    phi): the soft values within rtol (SOFT_RTOL by default) of max|twin|,
    and the raw correlation too (exact for int8 rows).  Returns (max
    |kernel - twin|, max|twin|, a note on the correlation)."""
    import torch
    from opv_tpu_torch.ops import symbol_soft as ss
    got = ss.symbol_soft_cuda(*ops, nsym)
    want = ss.symbol_soft_reference(*ops, nsym)
    raw_k = ss.symbol_soft_cuda(*ops, nsym, raw=True)
    raw_t = ss.symbol_soft_reference(*ops, nsym, raw=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale_ref = float(want.abs().max())
    if not err <= rtol * scale_ref:
        raise AssertionError(f"{what}: max |kernel - twin| {err:.4g} "
                             f"> {rtol} x {scale_ref:.4g}")
    if ops[0].dtype == torch.int8:
        if not torch.equal(raw_k, raw_t):
            raise AssertionError(f"{what}: s32 dot differs from the twin's "
                                 "int32 contraction")
        return err, scale_ref, "s32 dot exact"
    raw_err = float((raw_k - raw_t).abs().max())
    raw_ref = float(raw_t.abs().max())
    if not raw_err <= rtol * raw_ref:
        raise AssertionError(f"{what} correlation: {raw_err:.4g} > "
                             f"{rtol} x {raw_ref:.4g}")
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


def sync_checked(obj, name: str, checked: list):
    """Run every call of obj.name under torch.cuda.set_sync_debug_mode(
    "error"), so a synchronizing CUDA call there raises, counting the
    calls into checked[0].  Returns the original, for restoring."""
    import torch
    fn = getattr(obj, name)

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked[0] += 1
        return out
    setattr(obj, name, strict)
    return fn


def strict_launches(sd) -> list:
    """Run every predicted launch of the pipelined engine `sd` (window
    complete -> predicted program queued, _launch_predicted) under the
    sync-debug check.  Returns [launches checked], counting as they run."""
    checked = [0]
    sync_checked(sd, "_launch_predicted", checked)
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


def modem_echo(argv, frames):
    """Frames sent to opv_modem `argv` (a process) a frame's time apart
    after CLI_ECHO_WARM of warm-up: (echoes, the first one's ms, sorted
    echo ms after the warm-up).  The last frame stays in the modem (its
    tail waits for the next frame's samples)."""
    import socket
    proc, port = start_modem(argv)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    sent_at, back = {}, []

    def paced(batch, until):
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
        raise AssertionError(f"opv_modem {argv}: echoed frames are not the "
                             "frames sent, in order")
    cold = (back[0][1] - sent_at[back[0][0]]) * 1e3
    lat = sorted((t - sent_at[b]) * 1e3 for b, t in back[CLI_ECHO_WARM:])
    return len(back), cold, lat


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
    n_back, cold, lat = modem_echo(["-l", "--fast"], frames)
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
        f"-l --fast echoed {n_back}/{len(frames)} frames sent every "
        f"{CLI_PACING_S * 1e3:.0f} ms byte-equal: the first {cold:.1f} ms "
        f"after it was sent, then over {len(lat)} frames after "
        f"{CLI_ECHO_WARM} of warm-up echo latency p50 {p50:.2f} ms p95 "
        f"{p95:.2f} ms (host clock); -t -o stdout == tee == the exact "
        f"modulation of 2 frames ({card})")
    return dict(default_device_demod_s=demod_s, echo_frames=n_back,
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


def wideband_feed(dev, k: int | None = None):
    """wideband-64: (n,) complex64 on `dev`, k channels (WB_K unless
    given) each carrying WB_FRAMES BERT frames of its own station
    (callsign CH<c>, frame_num arange + 100 c), channel c starting after
    WB_LEAD + WB_LEAD_STEP c channel samples; summed in complex128 by the
    port's simulation helpers.  Returns (x, the frames by channel
    [[bytes]])."""
    import torch
    from opv_tpu_torch.core.framing import build_bert_frame
    from opv_tpu_torch.rx.channelizer import msk_wideband, synthesize_wideband
    k, frames, x = k or WB_K, [], None
    for c in range(k):
        fr = build_bert_frame(f"CH{c:02d}",
                              frame_num=np.arange(WB_FRAMES) + 100 * c)
        frames.append([bytes(f) for f in fr])
        s = msk_wideband(fr, k, device=dev)
        if x is None:
            n = (WB_LEAD + WB_LEAD_STEP * (k - 1)) * k + s.shape[0]
            x = torch.zeros(n, dtype=torch.complex128, device=dev)
        lead = (WB_LEAD + WB_LEAD_STEP * c) * k
        s = torch.cat([torch.zeros(lead, dtype=s.dtype, device=dev), s])
        x += synthesize_wideband({c: s}, k, x.shape[0], device=dev)
        del s
    return x.to(torch.complex64), frames


def drive_wideband(rx, x, chunks=None):
    """Feed `x` to the WidebandReceiver `rx`: one window, then
    quantum-sized feeds (one channelize call and one engine feed each),
    the rest, then flush(); or the given chunk sizes (any number of
    channelize calls per feed), the rest, then flush()."""
    import torch
    out = []
    if chunks is None:
        out += rx.feed(x[: rx.window])
        off = rx.window
        while off + rx.quantum <= x.shape[0]:
            out += rx.feed(x[off:off + rx.quantum])
            off += rx.quantum
    else:
        off = 0
        for m in chunks:
            out += rx.feed(x[off:off + m])
            off += m
    out += rx.feed(x[off:]) + rx.flush()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return out


def wideband_k4():
    """tests/test_wideband.py::test_streaming_decode's signal on the CPU:
    K = 4, 6 frames on channels 0 and 2 after a 2000-sample lead, (n,)
    complex128; and the frames by channel [[bytes]]."""
    import torch
    from opv_tpu_torch.core.framing import build_bert_frame
    from opv_tpu_torch.rx.channelizer import msk_wideband, synthesize_wideband
    k = 4
    sets = {0: build_bert_frame("W5NYV", frame_num=np.arange(6)),
            2: build_bert_frame("TEST", frame_num=np.arange(6))}
    sig = {c: torch.cat([torch.zeros(2000 * k, dtype=torch.complex128),
                         msk_wideband(f, k, device="cpu")])
           for c, f in sets.items()}
    x = synthesize_wideband(sig, k, max(s.shape[0] for s in sig.values()),
                            device="cpu")
    return x, [[bytes(f) for f in sets.get(c, [])] for c in range(k)]


def k4_chunks(n: int) -> list:
    """That test's ragged feed: sizes from numpy's generator, seed 0."""
    rng, sizes = np.random.default_rng(0), []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(10_000, 400_000)))
    return sizes


def check_wideband(out, frames, what: str) -> dict:
    """Every transmitted frame emitted at most once, byte-exact, on its own
    channel, metric <= 16, at positions a multiple of 86,720 apart (its
    index in the channel's stream); any other tuple has a metric above
    WB_LEAK_METRIC.  Returns {channel: frames lost} and the other tuples'
    count."""
    owner = {b: (c, j) for c, fs in enumerate(frames) for j, b in enumerate(fs)}
    lost, other = {}, 0
    for c, fs in enumerate(frames):
        mine = [r for r in out if r[0] == c]
        true = [r for r in mine if r[1] in owner]
        swapped = [owner[r[1]][0] for r in true if owner[r[1]][0] != c]
        idx = [owner[r[1]][1] for r in true]
        bad = [(r[2], r[4]) for r in true if r[2] > 16]
        grid = {r[4] - SPF * owner[r[1]][1] for r in true}
        if swapped or len(set(idx)) != len(idx) or bad or len(grid) > 1:
            raise AssertionError(
                f"wideband {what} channel {c}: frames of channels {swapped}; "
                f"frame indices {idx}; metric > 16 at {bad[:4]}; grid "
                f"origins {sorted(grid)[:4]}")
        junk = [(r[2], r[4]) for r in mine if r[1] not in owner]
        if any(m <= WB_LEAK_METRIC for m, _ in junk):
            raise AssertionError(f"wideband {what} channel {c}: frames not "
                                 f"transmitted with metric <= "
                                 f"{WB_LEAK_METRIC}: {junk[:4]}")
        other += len(junk)
        if len(fs) - len(true):
            lost[c] = len(fs) - len(true)
    return dict(lost=lost, other=other)


def same_wideband(got, want, frames, what: str) -> dict:
    """The card's tuples against the CPU's (or another run's): the same
    count, channels and positions; bytes, metric and sync quality (within
    STREAM_Q_TOL) equal wherever either tuple is a transmitted frame.
    Frames not transmitted (a quiet channel's leakage, a false lock's
    garbage) decode from soft values that are small differences of large
    tone energies, so float32 order moves their bits and their sync
    quality: there both metrics must exceed WB_LEAK_METRIC and the sync
    qualities agree within WB_GARBAGE_Q_TOL (the lock decisions they feed
    show in the positions of every later tuple).  Returns how many such
    tuples differed in bits and their largest sync-quality difference."""
    sent = {b for fs in frames for b in fs}
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tuples against {len(want)}")
    diff, dq = 0, 0.0
    for g, w in zip(got, want):
        garbage = g[1] not in sent and w[1] not in sent \
            and min(g[2], w[2]) > WB_LEAK_METRIC
        tol = WB_GARBAGE_Q_TOL if garbage else STREAM_Q_TOL
        if (g[0], g[4]) != (w[0], w[4]) or abs(g[3] - w[3]) > tol \
                or ((g[1], g[2]) != (w[1], w[2]) and not garbage):
            raise AssertionError(f"{what}: tuple {(g[0], g[2], g[3], g[4])} "
                                 f"against {(w[0], w[2], w[3], w[4])}")
        if garbage:
            diff += (g[1], g[2]) != (w[1], w[2])
            dq = max(dq, abs(g[3] - w[3]))
    return dict(garbage_differing=diff, garbage_max_dq=dq)


def channelize_bound(n_in: int, k: int, m: int, taps: int = 12):
    """(bound ms, what bounds it) of one channelize call: the wideband
    input read once and the (K, M) complex64 output written once, against
    the float32 polyphase legs (a multiply and an add per tap and real
    component) and the float64 DFT product (2 x M x 2K x 2K)."""
    nbytes = 8 * n_in + 8 * k * m
    t_ops = (m * k * 2 * taps * 2 / PEAK_OPS_PER_S["f32"]
             + 2 * m * (2 * k) ** 2 / PEAK_OPS_PER_S["f64_tensor"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def periodic_wideband(dev):
    """A frame-periodic WB_K-channel stream for the throughput arms: one
    station's frames 1..P (P >= WB_PERIOD_FRAMES, the smallest whose bits
    leave the modulator's sign state where it began, so the waveform
    wraps without a glitch) on every channel, channel c cyclically delayed
    by (c % 40) + 487 c samples.  Returns (x doubled by a window's worth
    for wrap-free slicing, its period in samples)."""
    import torch
    from opv_tpu_torch.core.framing import (build_bert_frame, encode_frame,
                                            frame_to_symbol_bits)
    from opv_tpu_torch.rx.channelizer import msk_wideband, synthesize_wideband
    k, p = WB_K, WB_PERIOD_FRAMES
    while True:
        fr = build_bert_frame("W5NYV", frame_num=np.arange(p + 1))
        bits = frame_to_symbol_bits(encode_frame(torch.from_numpy(fr[1:])))
        if int(bits.sum()) % 2 == 0:
            break
        p += 1
    s = msk_wideband(fr, k, device=dev)[SPF * k:(p + 1) * SPF * k]
    x = torch.zeros(s.shape[0], dtype=torch.complex128, device=dev)
    for c in range(k):
        d = ((c % 40) + 487 * c) * k
        x += synthesize_wideband({c: torch.roll(s, d)}, k, x.shape[0],
                                 device=dev)
    return x.to(torch.complex64), s.shape[0]


def wideband_throughput(xp, period: int, dev, dtype: str, pipeline: bool,
                        strict: bool = False):
    """A WidebandReceiver (block_frames WB_BF) on the periodic stream: one
    window, WB_WARM_QUANTA quanta, then WB_TIMED_QUANTA timed on the host
    clock (synchronized at both ends).  strict: every timed quantum's
    device work outside the result fetch (channelize, the wideband slide,
    the engine's append and its predicted launch) runs under
    torch.cuda.set_sync_debug_mode("error").  Returns a record."""
    import torch
    from opv_tpu_torch.stream import WidebandReceiver
    from opv_tpu_torch.stream import wideband as wbmod
    rx = WidebandReceiver(WB_K, block_frames=WB_BF, dtype=dtype,
                          pipeline=pipeline, timing=True, device=dev)
    q = rx.quantum
    src = torch.cat([xp, xp[: rx.window + q]])

    def chunk(pos):
        pos %= period
        return src[pos:pos + q]

    rx.feed(src[: rx.window])
    pos = rx.window
    for _ in range(WB_WARM_QUANTA):
        rx.feed(chunk(pos))
        pos += q
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    nb = len(rx.demod.block_stats)
    checked, restore = [0], []
    if strict:
        for obj, name in ((wbmod, "channelize"), (rx, "_slide"),
                          (rx.demod, "_append"),
                          (rx.demod, "_launch_predicted")):
            restore.append((obj, name, sync_checked(obj, name, checked)))
    t0 = time.perf_counter()
    for _ in range(WB_TIMED_QUANTA):
        rx.feed(chunk(pos))
        pos += q
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for obj, name, fn in restore:
        setattr(obj, name, fn)
    blocks = rx.demod.block_stats[nb:]
    msps = WB_TIMED_QUANTA * q / dt / 1e6
    rec = dict(msamples_s=msps, x_real_time=msps / (WB_K * REAL_TIME_MSPS),
               ms_per_quantum=dt * 1e3 / WB_TIMED_QUANTA,
               device_wait_ms=statistics.mean(b["device_wait_ms"]
                                              for b in blocks),
               host_ms=statistics.mean(b["host_ms"] for b in blocks),
               steady=sum(b["tag"] == "steady" for b in blocks),
               blocks=len(blocks),
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    if strict:
        rec["sync_checked_calls"] = checked[0]
        if checked[0] < 3 * WB_TIMED_QUANTA:
            raise AssertionError(f"sync-debug arm checked {checked[0]} calls "
                                 f"in {WB_TIMED_QUANTA} quanta")
    return rec


def phase_wideband(dev, card):
    """The wideband receiver on the card at K = 64 (phase 10)."""
    import torch
    from opv_tpu_torch.cli import opv_demod
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.rx.channelizer import channelize
    from opv_tpu_torch.stream import WidebandReceiver
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    x, frames = wideband_feed(dev)
    torch.cuda.synchronize(dev)
    n = x.shape[0]
    n_sent = sum(len(f) for f in frames)
    log(f"[wideband] wideband-{WB_K}: {n} samples ({n * 8 / 1e6:.0f} MB "
        f"complex64) synthesized on the card in "
        f"{time.perf_counter() - t_phase:.1f} s; {n_sent} frames, channel c "
        f"from sample {WB_LEAD} + {WB_LEAD_STEP} c")
    res = {}
    # (a) the channelizer over one quantum: card against CPU, ms, bound
    rx = WidebandReceiver(WB_K, block_frames=WB_BF, device=dev)
    win = x[: rx.window]
    y = channelize(win, WB_K)
    y_cpu = channelize(win.cpu(), WB_K)
    err = float((y.cpu() - y_cpu).abs().max())
    ref = float(y_cpu.abs().max())
    if not err <= WB_Y_RTOL * ref:
        raise AssertionError(f"channelize card vs cpu: {err:.4g} > "
                             f"{WB_Y_RTOL} x {ref:.4g}")
    ms = cuda_ms(lambda: channelize(win, WB_K), WB_CHAN_REPS)
    m = y.shape[1]
    bound_ms, bound_by, nbytes = channelize_bound(win.shape[0], WB_K, m)
    del y, y_cpu
    res["channelize"] = dict(ms=ms, max_abs_err=err, max_rel_err=err / ref,
                             bound_ms=bound_ms, bound_by=bound_by,
                             input_samples=win.shape[0], output=[WB_K, m],
                             ms_air=m / REAL_TIME_MSPS / 1e3)
    log(f"[wideband] (a) channelize {win.shape[0]} samples -> ({WB_K}, {m}) "
        f"on the card against the cpu: max |card - cpu| {err:.4g} of "
        f"max|y| {ref:.4g} (rel {err / ref:.3g}); {ms:.3f} ms per quantum "
        f"({m / REAL_TIME_MSPS / 1e3:.1f} ms of air), bound {bound_ms:.4f} "
        f"ms ({bound_by}, {nbytes / 1e6:.0f} MB) ({card})")
    # (b)-(e): the counted runs of the phase
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    runs = {}
    rx = WidebandReceiver(WB_K, block_frames=WB_BF, device=dev, timing=True)
    held, remove = spy_kernels(rx.demod)
    t0 = time.perf_counter()
    runs["b"] = drive_wideband(rx, x)
    dt_b = time.perf_counter() - t0
    remove()
    after_b = registry.launch_counts()
    if min(after_b["viterbi_r4"], after_b["symbol_soft[float32]"]) <= 0:
        raise AssertionError(f"wideband (b): a kernel never launched {after_b}")
    res["b"] = check_wideband(runs["b"], frames, "(b) float32")
    res["b"].update(tuples=len(runs["b"]), seconds=dt_b,
                    blocks=rx.stats().get("blocks_by_program"),
                    metric0=sum(r[2] == 0 for r in runs["b"]))
    # the same feed at a level an int16 capture of K carriers can hold
    # (each carrier x WB_WIRE_GAIN, as in (h)): every frame comes out
    x_wire = x * WB_WIRE_GAIN
    level = drive_wideband(WidebandReceiver(WB_K, block_frames=WB_BF,
                                            device=dev), x_wire)
    res["b"]["at_wire_level"] = check_wideband(level, frames,
                                               "(b) float32 at the wire level")
    if res["b"]["at_wire_level"]["lost"]:
        raise AssertionError(f"wideband (b) at the wire level: frames lost "
                             f"{res['b']['at_wire_level']['lost']}")
    # (c) pipelined and (d) ragged chunks, at full scale and at the wire
    # level, each equal to (b) on the same feed
    rng = np.random.default_rng(WB_RAGGED_SEED)
    sizes = rng.integers(*WB_RAGGED, size=n // WB_RAGGED[0] + 1)
    sizes = sizes[: int(np.searchsorted(np.cumsum(sizes), n)) + 1]
    for feed, want, at in ((x, runs["b"], ""),
                           (x_wire, level, " at the wire level")):
        got = drive_wideband(WidebandReceiver(WB_K, block_frames=WB_BF,
                                              pipeline=True, device=dev),
                             feed)
        same_stream(got, want, f"wideband (c) pipelined vs (b){at}")
        got = drive_wideband(WidebandReceiver(WB_K, block_frames=WB_BF,
                                              device=dev), feed, chunks=sizes)
        same_stream(got, want, f"wideband (d) ragged vs (b){at}")
    del got, level
    # (e) int8 rows with AGC: synchronous and pipelined at the wire level,
    # where every frame must come out, and synchronous at full scale, held
    # against the same receiver on the cpu below
    int8 = {pipe: drive_wideband(
        WidebandReceiver(WB_K, block_frames=WB_BF, dtype="int8",
                         pipeline=pipe, device=dev), x_wire)
        for pipe in (False, True)}
    int8_full = drive_wideband(WidebandReceiver(WB_K, block_frames=WB_BF,
                                                dtype="int8", device=dev), x)
    del x_wire
    launches = registry.launch_counts()
    if launches["symbol_soft[int8]"] <= after_b["symbol_soft[int8]"]:
        raise AssertionError(f"wideband (e): int8 soft stage never launched "
                             f"{launches}")
    res["e"] = {name: dict(check_wideband(int8[pipe], frames,
                                          f"(e) int8 + AGC {name}"),
                           tuples=len(int8[pipe]))
                for name, pipe in (("synchronous", False),
                                   ("pipelined", True))}
    for name in ("synchronous", "pipelined"):
        if res["e"][name]["lost"]:
            raise AssertionError(f"wideband (e) int8 + AGC {name} at the "
                                 f"wire level: frames lost "
                                 f"{res['e'][name]['lost']}")
    # pipelined int8 AGC need not be the synchronous engine's stream: its
    # adoptions read one more feed of statistics (ROADMAP queue 3)
    res["e"]["differing"] = len(set(int8[True]) ^ set(int8[False]))
    res["e"]["full_scale"] = dict(check_wideband(int8_full, frames,
                                                 "(e) int8 + AGC full scale"),
                                  tuples=len(int8_full))
    kernels = hold_stream_kernels(held, "wideband float32")
    del held
    # (b) against the same receiver on the CPU (the plain twins)
    t0 = time.perf_counter()
    cpu_b = drive_wideband(WidebandReceiver(WB_K, block_frames=WB_BF,
                                            device=cpu), x.cpu())
    res["b"]["cpu_seconds"] = time.perf_counter() - t0
    res["b"]["vs_cpu"] = same_wideband(runs["b"], cpu_b, frames,
                                       "wideband (b) card vs cpu")
    del cpu_b
    cpu_e = drive_wideband(WidebandReceiver(WB_K, block_frames=WB_BF,
                                            dtype="int8", device=cpu), x.cpu())
    res["e"]["full_scale"]["vs_cpu"] = same_wideband(
        int8_full, cpu_e, frames, "wideband (e) int8 full scale card vs cpu")
    del cpu_e, int8_full
    lost_b = res["b"]["lost"]
    log(f"[wideband] (b) synchronous float32, block_frames {WB_BF}: "
        f"{len(runs['b'])} tuples equal to the same receiver on the cpu "
        f"({res['b']['vs_cpu']['garbage_differing']} garbage tuples differ in "
        f"bits, both metrics > {WB_LEAK_METRIC}; their sync quality within "
        f"{res['b']['vs_cpu']['garbage_max_dq']:.3g}); "
        f"{n_sent - sum(lost_b.values())}"
        f"/{n_sent} transmitted frames emitted once, byte-exact, on their "
        f"channel, metric <= 16 ({res['b']['metric0']} at 0), one 86,720 "
        f"grid per channel; lost {sum(lost_b.values())} (by channel "
        f"{lost_b}); {res['b']['other']} garbage tuples (metric > "
        f"{WB_LEAK_METRIC}); blocks {res['b']['blocks']}; {dt_b:.2f} s on the "
        f"card, {res['b']['cpu_seconds']:.1f} s on the cpu.  Each carrier x "
        f"{WB_WIRE_GAIN:.5f} (the level of (h)): {n_sent}/{n_sent} frames, "
        f"{res['b']['at_wire_level']['other']} garbage tuples")
    log(f"[wideband] (c) pipelined and (d) {len(sizes)} ragged chunks "
        f"(numpy seed {WB_RAGGED_SEED}, {WB_RAGGED[0]}-{WB_RAGGED[1]}): "
        f"tuples equal to (b)'s, at full scale and at the wire level "
        f"({n_sent}/{n_sent} frames)")
    for name in ("synchronous", "pipelined"):
        e = res["e"][name]
        log(f"[wideband] (e) int8 + AGC {name}, each carrier x "
            f"{WB_WIRE_GAIN:.5f}: {n_sent}/{n_sent} transmitted frames once, "
            f"byte-exact, on their channel, metric <= 16; {e['other']} "
            f"garbage tuples; {e['tuples']} tuples")
    log(f"[wideband] (e) int8 + AGC pipelined against synchronous: "
        f"{res['e']['differing']} tuples in one run only")
    e = res["e"]["full_scale"]
    log(f"[wideband] (e) int8 + AGC synchronous at full scale: {e['tuples']} "
        f"tuples equal to the same receiver on the cpu "
        f"({e['vs_cpu']['garbage_differing']} garbage tuples differ in bits, "
        f"both metrics > {WB_LEAK_METRIC}; their sync quality within "
        f"{e['vs_cpu']['garbage_max_dq']:.3g}); "
        f"{n_sent - sum(e['lost'].values())}/{n_sent} transmitted frames "
        f"once, byte-exact, on their channel; lost {sum(e['lost'].values())} "
        f"(by channel {e['lost']}); {e['other']} garbage tuples")
    for h in kernels:
        rel = (f" (rel {h['max_rel_err']:.3g})" if "max_rel_err" in h
               else ", bit-identical")
        log(f"[wideband] (b) {h['program']} block: {h['kernel']} at the "
            f"engine's operands {h['shape']} against its twin, max |kernel - "
            f"twin| {h['max_abs_err']:.4g}{rel}")
    log(f"[wideband] launches over (b)-(e) {launches}")
    del runs, int8
    # (f) the K = 4 signal of tests/test_wideband.py::test_streaming_decode
    x4, sets4 = wideband_k4()
    four = [drive_wideband(WidebandReceiver(4, block_frames=3, device=d), x4,
                           chunks=k4_chunks(x4.shape[0]))
            for d in (dev, cpu)]
    diff4 = same_wideband(four[0], four[1], sets4,
                          "wideband (f) K=4 card vs cpu")
    res["f"] = check_wideband(four[0], sets4, "(f) K=4")
    if res["f"]["lost"]:
        raise AssertionError(f"wideband (f): frames lost {res['f']['lost']}")
    res["f"].update(tuples=len(four[0]), vs_cpu=diff4)
    log(f"[wideband] (f) K=4 test_streaming_decode signal, ragged feeds: card "
        f"tuples equal the cpu's ({len(four[0])} tuples; 12/12 frames of "
        f"channels 0 and 2; {res['f']['other']} leakage tuples on channels 1 "
        f"and 3, {diff4['garbage_differing']} differing in bits with both "
        f"metrics > {WB_LEAK_METRIC}, sync quality within "
        f"{diff4['garbage_max_dq']:.3g})")
    # (g) throughput on a frame-periodic stream
    xp, period = periodic_wideband(dev)
    thr = {}
    for name, dtype, pipe, strict in (
            ("float32 synchronous", "float32", False, False),
            ("float32 pipelined", "float32", True, False),
            ("int8 + AGC synchronous", "int8", False, False),
            ("int8 + AGC pipelined", "int8", True, False),
            ("float32 pipelined, sync-debug check", "float32", True, True)):
        r = wideband_throughput(xp, period, dev, dtype, pipe, strict)
        thr[name] = r
        log(f"[wideband] (g) {name}: {WB_TIMED_QUANTA} quanta "
            f"{r['ms_per_quantum']:.3f} ms each = {r['msamples_s']:.1f} "
            f"Msamples/s = {r['x_real_time']:.2f} x real time "
            f"({WB_K * REAL_TIME_MSPS:.2f} Msamples/s); per block "
            f"{r['device_wait_ms']:.3f} ms waiting on the results, "
            f"{r['host_ms']:.3f} ms lifecycle; {r['steady']}/{r['blocks']} "
            f"steady; peak memory {r['peak_bytes'] / 2**30:.2f} GiB"
            + (f"; {r['sync_checked_calls']} calls under "
               f"set_sync_debug_mode('error')" if strict else "")
            + f" ({card})")
    res["g"] = thr
    del xp
    # (h) opv_demod -s --fast --wideband 64 -r -q on (b)'s signal as wire
    gain = WB_WIRE_GAIN
    scaled = torch.round(torch.view_as_real(x) * gain)
    peak = float(scaled.abs().max())
    if peak > 32767:
        raise AssertionError(f"wideband wire: a sample clips ({peak})")
    wire = scaled.to(torch.int16).cpu().numpy().tobytes()
    del scaled
    t0 = time.perf_counter()
    rc, out, err = run_main(opv_demod.main, ["-s", "--fast", "--wideband",
                                             str(WB_K), "-r", "-q"], wire)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if rc != 0 or len(out) % 134:
        raise AssertionError(f"wideband (h): rc {rc}, {len(out)} bytes; "
                             f"{err[-500:]}")
    # the receiver the CLI builds, fed the same samples in the same quanta
    xw = torch.view_as_complex(torch.from_numpy(
        np.frombuffer(wire, "<i2").astype(np.float32).reshape(-1, 2))).to(dev)
    rxh = WidebandReceiver(WB_K, block_frames=WB_CLI_BLOCK, pipeline=True,
                           device=dev)
    ref = drive_wideband(rxh, xw, chunks=[rxh.quantum] * (n // rxh.quantum))
    if out != b"".join(r[1] for r in ref):
        raise AssertionError(f"wideband (h): {len(out) // 134} frames, not "
                             f"the {len(ref)} its receiver emits")
    res["h"] = check_wideband(ref, frames, "(h) cli")
    msps = n / dt / 1e6
    res["h"].update(seconds=dt, msamples_s=msps,
                    x_real_time=msps / (WB_K * REAL_TIME_MSPS),
                    frames=len(out) // 134, wire_peak=peak)
    lost_h = res["h"]["lost"]
    log(f"[wideband] (h) opv_demod -s --fast --wideband {WB_K} -r -q "
        f"in-process on (b)'s signal as int16 wire bytes (each channel x "
        f"{gain:.5f}, peak |sample| {peak:.0f}, none clips): "
        f"{len(out) // 134} frames == its receiver on the same samples; "
        f"{n_sent - sum(lost_h.values())}/{n_sent} transmitted frames once, "
        f"byte-exact, on their channel; lost {sum(lost_h.values())} (by "
        f"channel {lost_h}); {n} samples in {dt:.3f} s host clock = "
        f"{msps:.1f} Msamples/s = {res['h']['x_real_time']:.2f} x real time "
        f"({card})")
    log(f"[wideband] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, kernels=kernels, **res)


def capture(name: str) -> np.ndarray:
    """A golden capture (tests/golden/NAME.iq) as complex128 samples."""
    raw = np.frombuffer(golden(f"{name}.iq"), "<i2").reshape(-1, 2)
    return raw[:, 0].astype(np.float64) + 1j * raw[:, 1]


def golden_frames(name: str) -> list:
    data = golden(name)
    return [data[i:i + 134] for i in range(0, len(data), 134)]


def track_inputs(channels: int, dev, real=None):
    """The inputs of one chunk of a StreamingDemodulator's first call, per
    channel: (samples (C, 86,720) complex128, n_valid (C,) int32, state
    (C, 9) float64) on dev, or complex64 and float32 with real=float32.
    Channel c holds the first chunk of capture c % 7 of TRACK_CAPTURES,
    its loop state fresh at the capture's CFO estimate (the single-channel
    estimate, as the first chunk runs it)."""
    import torch
    from opv_tpu_torch.rx.cfo import estimate_cfo
    from opv_tpu_torch.rx.demod import (complex_dtype, loop_state_init,
                                        pack_state)
    real = real or torch.float64
    first = [torch.from_numpy(capture(n)[:SPF]).to(dev, complex_dtype(real))
             for n in TRACK_CAPTURES]
    offs = [estimate_cfo(x) for x in first]
    pick = [c % len(first) for c in range(channels)]
    x = torch.stack([first[i] for i in pick])
    state = pack_state(loop_state_init(torch.stack([offs[i] for i in pick]),
                                       channels=channels, device=dev,
                                       dtype=real))
    nv = torch.full((channels,), SPF, dtype=torch.int32, device=dev)
    return x, nv, state


def track_edge_case(name: str, dev, real=None):
    """track_symbols inputs (samples, n_valid, state) on dev at an edge of
    the kernel's sample ring (TRACK_EDGE_CASES, and at real=float32 also
    TRACK_F32_EDGE_CASES), complex128/float64 or complex64/float32 (real),
    from its CFO estimate:
      whole capture   one launch over all 697,618 samples of drift, as
                      rx_batch runs it (1,363 tiles of 512)
      cap 64, 100     two channels of bert3 with n_valid (0, 49) and
                      (49, 100): none (cap 64) or one channel (cap 100)
                      steps, in one tile cut at cap
      clamp 1, 2      bert3 cut where symbol 60, the last active one, has
                      its window base clamped at cap - 64 (pos - 11 above
                      it by one and by two samples)
      C=133           track_inputs at 133 channels, more blocks than SMs
      storage offset  track_inputs at 7 channels as a view 5 samples into
                      its storage (complex64: 40 bytes, off 16)
      odd cap         (float32) bert3 and cfo500 cut to 86,719 samples, all
                      of them valid: an odd row (the kernel's bulk copies
                      move whole 16 bytes, so the wrapper pads the rows)
      odd rows        (float32) 3 channels of 10,001 samples of bert3,
                      cfo500 and awgn8, n_valid 10,001, 9,998 and 1,001:
                      rows 1 and 2 start off 16 bytes and the last tile
                      of each row is odd"""
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.ops import track_symbols as ts
    from opv_tpu_torch.rx.cfo import estimate_cfo
    from opv_tpu_torch.rx.demod import (complex_dtype, loop_state_init,
                                        pack_state)
    i32 = dict(dtype=torch.int32, device=dev)
    real = real or torch.float64
    cplx = complex_dtype(real)

    def fresh(x, c=1):
        return pack_state(loop_state_init(estimate_cfo(x).reshape(1).expand(c),
                                          channels=c, device=dev, dtype=real))

    def cut(names, n):
        return torch.stack([torch.from_numpy(capture(k)[:n]).to(dev, cplx)
                            for k in names])

    if name in ("C=133", "storage offset"):
        x, nv, state = track_inputs(133 if name == "C=133" else 7, dev, real)
        if name == "storage offset":
            buf = torch.zeros(x.numel() + 5, dtype=x.dtype, device=dev)
            x = buf[5:].view(x.shape).copy_(x)
        return x, nv, state
    if name == "whole capture":
        x = torch.from_numpy(capture("drift")).to(dev, cplx)
        return x[None], torch.tensor([x.shape[0]], **i32), fresh(x)
    if name == "odd cap":
        x = cut(("bert3", "cfo500"), SPF - 1)
        return x, torch.full((2,), SPF - 1, **i32), torch.cat(
            [fresh(x[0]), fresh(x[1])])
    if name == "odd rows":
        x = cut(("bert3", "cfo500", "awgn8"), 10_001)
        return x, torch.tensor([10_001, 9_998, 1_001], **i32), torch.cat(
            [fresh(r) for r in x])
    first = torch.from_numpy(capture("bert3")[:SPF]).to(dev, cplx)
    if name.startswith("cap"):
        cap = int(name.split()[1])
        nv = (0, 49) if cap == 64 else (49, 100)
        return (torch.stack([first[:cap], first[7:7 + cap]]),
                torch.tensor(nv, **i32), fresh(first, 2))
    # symbol 60 at p = samples_used after 60 steps; cap = p + 52 (p + 51)
    # puts its base p - 11 one (two) above cap - 64 and keeps it active
    state = fresh(first)
    p = int(ts.track_symbols_reference(
        first[None].cpu(), torch.tensor([SPF], dtype=torch.int32),
        state.cpu(), CONFIG.afc_alpha, 60)[3][0])
    cap = p + (52 if name == "clamp 1" else 51)
    return first[None, :cap], torch.tensor([cap], **i32), state


def hold_track(x, nv, state, what: str, run=None):
    """track_symbols on the card (`run`, the package's kernel by default)
    against its twin (on the host) on the same inputs: n_sym, samples_used
    and sym_valid equal, soft and the state within TRACK_RTOL (complex128)
    or, for complex64, soft within TRACK_F32_RTOL and the state within
    TRACK_F32_STATE_RTOL.  Returns (the kernel's outputs, the largest soft
    difference, the twin's host ms)."""
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.ops import track_symbols as ts
    from opv_tpu_torch.rx.demod import max_symbols
    maxs = max_symbols(x.shape[1])
    got = (run or ts.track_symbols_cuda)(x, nv, state, CONFIG.afc_alpha, maxs)
    t0 = time.perf_counter()
    want = ts.track_symbols_reference(x.cpu(), nv.cpu(), state.cpu(),
                                      CONFIG.afc_alpha, maxs)
    twin_ms = (time.perf_counter() - t0) * 1e3
    soft, valid, st, used = (t.cpu() for t in got)
    rtol = TRACK_RTOL if x.dtype == torch.complex128 else TRACK_F32_RTOL
    if soft.dtype != want[0].dtype or st.dtype != want[2].dtype:
        raise AssertionError(f"[tracking] {what}: track_symbols gave "
                             f"{soft.dtype}/{st.dtype} for {x.dtype}")
    if not (torch.equal(valid, want[1]) and torch.equal(used, want[3])):
        raise AssertionError(
            f"[tracking] {what}: track_symbols n_sym {valid.sum(1).tolist()} "
            f"samples_used {used.tolist()} != twin "
            f"{want[1].sum(1).tolist()} {want[3].tolist()}")
    err = float((soft - want[0]).abs().max())
    if err > rtol * max(1.0, float(want[0].abs().max())):
        raise AssertionError(f"[tracking] {what}: track_symbols soft differs "
                             f"from the twin by {err:.3e}")
    st, st_want = st.double(), want[2].double()
    d = (st - st_want).abs()
    d[:, 1:3] = torch.remainder(st[:, 1:3] - st_want[:, 1:3] + np.pi,
                                2 * np.pi).sub(np.pi).abs()
    scale = st_want.abs().amax(0).clamp(min=1.0)
    if x.dtype == torch.complex64:
        rtol = TRACK_F32_STATE_RTOL
        for j in (5, 7):       # prev_c1, prev_c2: complex differences
            mag = torch.hypot(st_want[:, j], st_want[:, j + 1]).max()
            d[:, j:j + 2] = torch.hypot(d[:, j], d[:, j + 1])[:, None]
            scale[j:j + 2] = mag.clamp(min=1.0)
    if bool((d > rtol * scale).any()):
        raise AssertionError(f"[tracking] {what}: track_symbols state differs "
                             f"from the twin by {d.amax(0).tolist()}")
    return got, err, twin_ms


SYNC_OUTPUTS = ("ints", "sync_q", "ready", "q", "events", "ev_misses",
                "ev_frames", "raw", "norm")


def same_sync(got, want, what: str, names=SYNC_OUTPUTS) -> None:
    """Every output of the sync_scan kernel (named `names`) equal to its
    twin's, bit for bit (the float ones compared as bytes)."""
    import torch

    def bits(t):
        t = t.cpu()
        return t.view(torch.uint8) if t.is_floating_point() else t
    bad = [n for n, a, b in zip(names, got, want)
           if a.shape != b.shape or not torch.equal(bits(a), bits(b))]
    if bad or len(got) != len(want):
        raise AssertionError(f"[tracking] {what}: sync_scan differs from the "
                             f"twin in {bad}")


def hold_sync(raw, norm, valid, ints, q, what: str, run=None):
    """sync_scan on given raw/norm (GivenSync; `run`, the package's kernel
    by default) against its twin, every output bit for bit.  Returns (the
    kernel's outputs, the twin's host ms)."""
    from opv_tpu_torch.ops import sync_scan as sc
    got = (run or sc.sync_scan_cuda)(raw, norm, valid, ints, q)
    t0 = time.perf_counter()
    want = sc.sync_scan_reference(raw.cpu(), norm.cpu(), valid.cpu(),
                                  ints.cpu(), q.cpu())
    twin_ms = (time.perf_counter() - t0) * 1e3
    same_sync(got, want, f"{what} (GivenSync)")
    return got, twin_ms


def hold_sync_soft(soft_ext, valid, ints, q, what: str, run=None):
    """sync_scan with the correlation as its input stage (SoftSync; `run`,
    the package's kernel by default) against sync_correlate and the twin,
    every output bit for bit, raw and norm too.  Returns (the kernel's
    outputs, the twins' host ms)."""
    from opv_tpu_torch.ops import sync_scan as sc
    got = (run or sc.sync_correlate_scan_cuda)(soft_ext, valid, ints, q)
    t0 = time.perf_counter()
    want = sc.sync_correlate_scan_reference(soft_ext.cpu(), valid.cpu(),
                                            ints.cpu(), q.cpu())
    twin_ms = (time.perf_counter() - t0) * 1e3
    same_sync(got, want, f"{what} (SoftSync)")
    return got, twin_ms


def sync_stress(channels: int, steps: int, dev):
    """sync_scan inputs that reach every transition: raw/norm drawn from
    values on either side of each threshold, channels starting in each
    state (and near the 2^30 total cap; every 6th one LOCKED on its 4th
    miss with a weak sync ahead, so it loses lock), every 7th symbol
    invalid."""
    import torch
    rng = np.random.default_rng(5)
    raw = rng.choice([0.0, 4999.0, 5000.0, 6.0e12], (channels, steps))
    norm = rng.choice([0.5, 0.7, 0.75, 0.85, 1.0], (channels, steps),
                      p=[0.3, 0.05, 0.3, 0.05, 0.3])
    valid = (np.arange(steps) % 7 != 6)[None].repeat(channels, 0)
    ints = _stress_ints(channels, rng)
    norm[np.arange(channels) % 6 == 2] = 0.5
    f64 = dict(dtype=torch.float64, device=dev)
    return (torch.tensor(raw, **f64), torch.tensor(norm, **f64),
            torch.tensor(valid, device=dev), torch.tensor(ints, device=dev),
            torch.zeros(channels, **f64))


def _stress_ints(channels: int, rng) -> np.ndarray:
    """Start carries in every state: sss anywhere in a frame, some misses,
    every 6th channel LOCKED on its 4th miss, half collecting, every 5th
    total 3 below the 2^30 cap."""
    ints = np.zeros((channels, 6), np.int32)
    ints[:, 0] = np.arange(channels) % 3
    ints[:, 1] = rng.integers(0, 2168, channels)
    ints[:, 2] = rng.integers(0, 5, channels)
    ints[np.arange(channels) % 6 == 2, 2] = 4
    ints[:, 3] = np.arange(channels) % 2
    ints[:, 4] = np.where(np.arange(channels) % 5 == 0, (1 << 30) - 3, 100)
    return ints


def plant_sync(row: np.ndarray, t: int, amp: float, flips: int = 0) -> None:
    """Write the sync word times amp at soft_ext[t:t + 24] (the window
    symbol t correlates), its first `flips` taps negated: norm 1 - flips/12
    (0.83 with 2, between the locked and hunt thresholds; 0.67 with 4,
    below both)."""
    from opv_tpu_torch.rx.sync import sync_pattern
    w = sync_pattern() * amp
    w[:flips] = -w[:flips]
    row[t:t + 24] = w


def soft_stress(channels: int, steps: int, dev, seed: int = 7):
    """SoftSync inputs (soft_ext (C, 23 + S) float64, valid (C, S), ints
    (C, 6), q (C,)) on dev that reach every transition through the
    correlation: noise of sigma 20 with sync words planted mostly 2168
    symbols apart (else 24, 2144 or at random), 0, 2 or 4 taps flipped,
    at amplitudes 1000 (raw past the hunt's 5000), 100 (not) or 1 (energy
    under the gate), a stretch of zeros a row; channels start as in
    _stress_ints; ~3% of the symbols of every 4th channel invalid (its
    checks drift off the words), and the last 1-40 of every row."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 20.0, (channels, steps + 23))
    for c in range(channels):
        t = int(rng.integers(0, 300))
        while t < steps:
            plant_sync(x[c], t, rng.choice([1000.0, 1000.0, 100.0, 1.0]),
                       int(rng.choice([0, 0, 0, 2, 4])))
            t += int(rng.choice([2168] * 6 + [24, 2144, rng.integers(1, 3000)]))
        z = int(rng.integers(0, steps + 23))
        x[c, z:z + 50] = 0.0
    valid = (rng.random((channels, steps)) > 0.03) \
        | (np.arange(channels) % 4 != 1)[:, None]
    if steps:
        for c in range(channels):
            valid[c, steps - int(rng.integers(1, 41)):] = False
    f64 = dict(dtype=torch.float64, device=dev)
    return (torch.tensor(x, **f64), torch.tensor(valid, device=dev),
            torch.tensor(_stress_ints(channels, rng), device=dev),
            torch.zeros(channels, **f64))


def sync_tile_edges(dev):
    """SoftSync inputs where the kernel's 32-symbol tiles meet the events:
    32 channels LOCKED and collecting, channel c's check at symbol c (lane
    c of the first tile), every frame's emit at lane c 2144 symbols later
    and its next check 24 after that (two events in one tile for c < 8):
    sync OK on channels c % 4 = 0, 2, a flywheel miss then OKs on c % 4 =
    1, a lost lock at the 5th miss on c % 4 = 3 with a new hunt hit 24
    symbols after it; on channels c % 8 = 6 symbol c - 1 is invalid (the
    check moves one lane on)."""
    import torch
    from opv_tpu_torch.config import CONFIG
    eb, fs = CONFIG.encoded_bits, CONFIG.frame_symbols
    c_n, steps = 32, 3 * fs
    rng = np.random.default_rng(12)
    x = rng.normal(0.0, 20.0, (c_n, steps + 23))
    valid = np.ones((c_n, steps), bool)
    ints = np.zeros((c_n, 6), np.int32)
    for c in range(c_n):
        ints[c] = (2, fs - 1 - c, 4 if c % 4 == 3 else 0, 1, 100, 7)
        at = c + 1 if c % 8 == 6 else c
        if c % 8 == 6:
            valid[c, c - 1] = False
        if c % 4 == 3:
            plant_sync(x[c], at + 24, 1000.0)
            at += 24 + eb
        else:
            plant_sync(x[c], at, 1000.0, 4 if c % 4 == 1 else 0)
        while at + fs < steps:
            at += fs
            plant_sync(x[c], at, 1000.0)
    f64 = dict(dtype=torch.float64, device=dev)
    return (torch.tensor(x, **f64), torch.tensor(valid, device=dev),
            torch.tensor(ints, device=dev), torch.zeros(c_n, **f64))


#: the inputs of sync_edge_case: the edges of the sync_scan kernel's tiles
#: and carries
SYNC_EDGE_CASES = ("S=0", "S=1", "S=31", "S=32", "S=33", "C=133",
                   "whole capture", "tile edges", "carry", "view")


def sync_edge_case(name: str, dev):
    """SoftSync inputs (soft_ext, valid, ints, q) on dev at an edge of the
    sync_scan kernel (SYNC_EDGE_CASES); GivenSync takes the same with raw
    and norm from sync_correlate:
      S=0 .. S=33     soft_stress at 3 channels: no symbol, one, and a
                      tile's 32 symbols less one, exact, one more
      C=133           soft_stress at 133 channels x 2284 symbols
      whole capture   soft_stress at 1 channel x 26,000 symbols (rx_batch
                      runs a whole capture as one block)
      tile edges      sync_tile_edges
      carry           soft_stress at 12 channels with carries at the int32
                      edges: total INT_MAX and 2^30 - 3, sss INT_MAX - 5,
                      each in HUNTING, VERIFYING and LOCKED; LOCKED and
                      collecting with sss 3000 > 2168 (no check until
                      sss wraps); sync quality 0.3
      view            soft_stress at 5 channels as the view
                      soft_cat[:, 2121:] of rx/pipeline.py: rows 8 bytes
                      off 16 at a stride of 2144 + S"""
    import torch
    from opv_tpu_torch.config import CONFIG
    if name.startswith("S="):
        return soft_stress(3, int(name[2:]), dev, seed=int(name[2:]))
    if name == "C=133":
        return soft_stress(133, 2284, dev)
    if name == "whole capture":
        return soft_stress(1, 26_000, dev)
    if name == "tile edges":
        return sync_tile_edges(dev)
    if name == "carry":
        x, valid, ints, q = soft_stress(12, 700, dev, seed=13)
        ints[:, 0] = torch.arange(12) % 3
        ints[0:3, 4] = 2**31 - 1
        ints[3:6, 4] = (1 << 30) - 3
        ints[6:9, 1] = 2**31 - 6
        ints[9:12] = torch.tensor([2, 3000, 0, 1, 100, 0], dtype=torch.int32)
        return x, valid, ints, torch.full_like(q, 0.3)
    if name == "view":
        eb = CONFIG.encoded_bits
        x, valid, ints, q = soft_stress(5, 2284, dev, seed=14)
        cat = torch.zeros((5, eb + 2284), dtype=torch.float64, device=dev)
        cat[:, eb - 23:] = x
        return cat[:, eb - 23:], valid, ints, q
    raise ValueError(f"no sync edge case {name!r}")


def track_bound(nsym: int, n_samples: int, channels: int, maxs: int,
                real_bytes: int = 8):
    """(bound ms, what bounds it) of track_symbols: the n_valid samples
    read once (2 reals), the state in and out, soft and sym_valid written
    (a real and a byte a slot), against TRACK_OPS_PER_SYMBOL operations
    for each symbol this run's data produced, at the float64 (real_bytes
    8) or float32 (4) peak."""
    r = real_bytes
    nbytes = n_samples * 2 * r + channels * (2 * 9 * r + 4 + 4) + \
        channels * maxs * (r + 1)
    return bound(nbytes, nsym * TRACK_OPS_PER_SYMBOL,
                 PEAK_OPS_PER_S["f64" if r == 8 else "f32"])


def sync_bound(channels: int, steps: int, int_ops_per_s: float,
               soft: bool = False, real_bytes: int = 8):
    """(bound ms, what bounds it) of sync_scan.  GivenSync: raw, norm and
    valid read once (2 reals and a byte a symbol), ready, q, events, misses
    and frames written (a byte, a real and 12 B), SYNC_OPS_PER_SYMBOL int32
    operations a symbol.  SoftSync: soft_ext (23 + S reals a row) and
    valid read once, the same outputs and raw and norm written (2 reals),
    and SYNC_F64_OPS_PER_SYMBOL float operations a symbol (float64 or, at
    real_bytes 4, float32) beside the int32 ones (separate pipes: the
    larger time bounds)."""
    r = real_bytes
    state = channels * 2 * (6 * 4 + r)
    out = 1 + r + 12
    if not soft:
        return bound(channels * steps * (2 * r + 1 + out) + state,
                     channels * steps * SYNC_OPS_PER_SYMBOL, int_ops_per_s)
    nbytes = channels * ((steps + 23) * r + steps * (1 + out + 2 * r)) + state
    fl = bound(nbytes, channels * steps * SYNC_F64_OPS_PER_SYMBOL,
               PEAK_OPS_PER_S["f64" if r == 8 else "f32"])
    i32 = bound(nbytes, channels * steps * SYNC_OPS_PER_SYMBOL, int_ops_per_s)
    return max(fl, i32)


def tracking_kernels(dev, card, int_ops_per_s: float):
    """(a) track_symbols and both sync_scan instantiations against their
    twins at C = 1 and C = TRACK_CHANNELS on one chunk of the golden mix,
    and their times; track_symbols on TRACK_EDGE_CASES, sync_scan on its
    stress inputs (held and timed) and SYNC_EDGE_CASES (held)."""
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.ops import build
    from opv_tpu_torch.ops import sync_scan as sc
    from opv_tpu_torch.ops import track_symbols as ts
    from opv_tpu_torch.rx.demod import max_symbols
    from opv_tpu_torch.rx.sync import sync_correlate
    eb = CONFIG.encoded_bits
    maxs = max_symbols(SPF)
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    entry = None
    for line in build.BUILD_INFO["ptxas"].splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in ("track_symbols", "GivenSync", "SoftSync")
                          if k in line), None)
            if entry and "IfE" in line:    # the float32 instantiation
                entry += "[float32]"
        elif entry and ("registers" in line or "spill" in line):
            log(f"[tracking] (a) {entry} ptxas: {line.strip()}")

    def time_sync(what, c, steps, soft_ext, valid, ints, q, twin_ms):
        """Both instantiations timed on the same symbols; GivenSync on the
        kernel's own raw/norm, beside the two-step route it replaces
        (torch's sync_correlate on the card, then GivenSync)."""
        got, soft_twin_ms = hold_sync_soft(soft_ext, valid, ints, q, what)
        raw, norm = got[7], got[8]
        given_ms = device_ms(lambda: sc.sync_scan_cuda(raw, norm, valid, ints,
                                                       q), SYNC_REPS)
        soft_ms = device_ms(lambda: sc.sync_correlate_scan_cuda(
            soft_ext, valid, ints, q), SYNC_REPS)
        corr_ms = device_ms(lambda: sync_correlate(soft_ext), SYNC_REPS)
        rows = {}
        for name, ms, plain, soft in (("GivenSync", given_ms, twin_ms, False),
                                      ("SoftSync", soft_ms, soft_twin_ms,
                                       True)):
            b_ms, b_by = sync_bound(c, steps, int_ops_per_s, soft)
            rows[f"sync_scan[{name}]"] = dict(
                ms=soft_ms if soft else given_ms, plain_ms=plain,
                max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                roofline=b_ms / ms, library_ms=None)
        rows["sync_scan[SoftSync]"]["two_step_ms"] = corr_ms + given_ms
        log(f"[tracking] (a) {what}: sync_scan bit-identical, both "
            f"instantiations ({int(got[2].sum())} frames ready, events by "
            f"code {np.bincount(got[4].cpu().numpy().ravel(), minlength=6).tolist()}): "
            f"GivenSync {given_ms:.4f} ms (twin {twin_ms:.0f} ms, bound "
            f"{rows['sync_scan[GivenSync]']['bound_ms']:.5f}), SoftSync "
            f"{soft_ms:.4f} ms (twins {soft_twin_ms:.0f} ms, bound "
            f"{rows['sync_scan[SoftSync]']['bound_ms']:.5f}), the two-step "
            f"route torch sync_correlate {corr_ms:.4f} + GivenSync ({card})")
        return rows

    rows = {}
    for c in (1, TRACK_CHANNELS):
        x, nv, state = track_inputs(c, dev)
        (soft, valid, _, _), err, twin_ms = hold_track(x, nv, state, f"C={c}")
        ms = cuda_ms(lambda: ts.track_symbols_cuda(x, nv, state,
                                                   CONFIG.afc_alpha, maxs),
                     TRACK_REPS)
        nsym = int(valid.sum())
        # ms as cycles a symbol of one channel's chain, at the max SM clock
        cyc = 1e3 * sm_mhz * c / nsym
        bound_ms, bound_by = track_bound(nsym, int(nv.sum()), c, maxs)
        rows[c] = dict(track_symbols=dict(
            ms=ms, plain_ms=twin_ms, max_abs_err=err, bound_ms=bound_ms,
            bound_by=bound_by, roofline=bound_ms / ms, library_ms=None,
            symbols=nsym))
        air_ms = SPF / REAL_TIME_MSPS / 1e3
        log(f"[tracking] (a) C={c}: track_symbols n_sym, samples_used and "
            f"sym_valid equal to the twin's, soft within {err:.3e} "
            f"(max|soft| {float(soft.abs().max()):.3e}); {nsym} symbols: "
            f"kernel {ms:.3f} ms per chunk ({ms * cyc:.0f} cycles a symbol "
            f"as ms x the max SM clock, {sm_mhz:.0f} MHz; {air_ms:.0f} ms "
            f"of air, {air_ms / ms:.1f}x real time), "
            f"twin {twin_ms:.0f} ms (host), "
            f"bound {bound_ms:.4f} ms ({bound_by}) ({card})")
        # sync_scan on the card's soft, from a zero history and HUNTING,
        # as rx_block_from_soft hands it over (the view of soft_cat)
        ext = torch.cat([torch.zeros((c, eb), dtype=torch.float64,
                                     device=dev), soft], 1)[:, eb - 23:]
        ints = torch.zeros((c, 6), dtype=torch.int32, device=dev)
        q0 = torch.zeros(c, dtype=torch.float64, device=dev)
        raw, norm = sync_correlate(ext)
        _, given_twin_ms = hold_sync(raw, norm, valid, ints, q0, f"C={c}")
        rows[c].update(time_sync(f"C={c}", c, maxs, ext, valid, ints, q0,
                                 given_twin_ms))
    for name in TRACK_EDGE_CASES:
        x, nv, state = track_edge_case(name, dev)
        (_, valid, _, used), err, twin_ms = hold_track(x, nv, state, name)
        log(f"[tracking] (a) track_symbols on {name} ({tuple(x.shape)}, "
            f"n_valid {nv.tolist()[:4]}): n_sym {valid.sum(1).tolist()[:4]} "
            f"and samples_used {used.tolist()[:4]} equal to the twin's, soft "
            f"within {err:.3e} (twin {twin_ms:.0f} ms)")
    stress = sync_stress(TRACK_CHANNELS, maxs, dev)
    (_, _, ready, _, events, _, _), _ = hold_sync(*stress, "stress")
    counts = np.bincount(events.cpu().numpy().ravel(), minlength=6).tolist()
    if min(counts) == 0:
        raise AssertionError(f"[tracking] the sync_scan stress reached only "
                             f"events {counts}")
    given_ms = device_ms(lambda: sc.sync_scan_cuda(*stress), SYNC_REPS)
    log(f"[tracking] (a) sync_scan GivenSync bit-identical on the stress "
        f"input ({TRACK_CHANNELS} x {maxs}, events by code {counts}, "
        f"{int(ready.sum())} ready): {given_ms:.4f} ms ({card})")
    x, valid, ints, q = soft_stress(TRACK_CHANNELS, maxs, dev)
    _, twin_ms = hold_sync(*sync_correlate(x), valid, ints, q, "soft stress")
    rows["stress"] = time_sync("soft stress", TRACK_CHANNELS, maxs, x, valid,
                               ints, q, twin_ms)
    rows["stress"]["sync_scan[GivenSync]"]["stress_ms"] = given_ms
    t0 = time.perf_counter()
    seen = Counter()
    for name in SYNC_EDGE_CASES:
        x, valid, ints, q = sync_edge_case(name, dev)
        got, _ = hold_sync_soft(x, valid, ints, q, name)
        hold_sync(got[7], got[8], valid, ints, q, name)
        seen.update(got[4].cpu().numpy().ravel().tolist())
    log(f"[tracking] (a) sync_scan both instantiations bit-identical on "
        f"{', '.join(SYNC_EDGE_CASES)} (events by code "
        f"{[seen[k] for k in range(6)]}; {time.perf_counter() - t0:.1f} s)")
    return rows


def sync_routes(dev, card, real=None):
    """The sync stage's two public routes on T1's soft for one chunk of
    the golden mix at TRACK_CHANNELS, from a zero history (rx/sync.py:
    sync_correlate then sync_scan, the GivenSync path; sync_correlate_scan,
    the SoftSync one), in float64 or (real) float32: every output equal.
    Returns the launches of the run (counts reset just before it)."""
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.rx.demod import max_symbols
    from opv_tpu_torch.rx.sync import (sync_correlate, sync_correlate_scan,
                                       sync_scan, sync_tracker_init)
    eb = CONFIG.encoded_bits
    real = real or torch.float64
    x, nv, state = track_inputs(TRACK_CHANNELS, dev, real)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    soft, valid, _, _ = registry.track_symbols(x, nv, state, CONFIG.afc_alpha,
                                               max_symbols(SPF))
    ext = torch.cat([torch.zeros((TRACK_CHANNELS, eb), dtype=real,
                                 device=dev), soft], 1)[:, eb - 23:]
    st = sync_tracker_init(TRACK_CHANNELS, device=dev, dtype=real)
    raw, norm = sync_correlate(ext)
    two = sync_scan(st, raw, norm, valid)
    one = sync_correlate_scan(st, ext, valid)
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    same_sync((*one[0], *one[1:]), (*two[0], raw, norm, *two[1:]),
              "(a) sync_correlate_scan against sync_correlate + sync_scan",
              names=(*st._fields, *SYNC_OUTPUTS[7:], *SYNC_OUTPUTS[2:7]))
    log(f"[{'tracking' if real == torch.float64 else 'precision'}] (a) "
        f"rx.sync.sync_correlate + sync_scan (GivenSync) and "
        f"sync_correlate_scan (SoftSync) equal on the card on "
        f"{TRACK_CHANNELS} x {valid.shape[1]} symbols in {real} "
        f"({int(one[3].sum())} frames ready); launches {launches} ({card})")
    return launches


def cpu_streaming(job):
    """A StreamingDemodulator on the host over one golden capture: its
    tuples (run in a worker process)."""
    import torch
    from opv_tpu_torch.stream import StreamingDemodulator
    torch.set_num_threads(1)
    name, opts = job
    sd = StreamingDemodulator(device="cpu", **opts)
    x = capture(name)
    return sd.feed(x) + sd.flush()


def same_tracking(got, want, what: str, q_tol: float = TRACK_Q_TOL) -> float:
    """Tuples (bytes, metric, q, symbol index) equal, q within q_tol;
    returns the largest q difference."""
    if [(t[0], t[1], t[3]) for t in got] != [(t[0], t[1], t[3]) for t in want]:
        raise AssertionError(
            f"[tracking] {what}: {len(got)} tuples against {len(want)}; "
            f"(metric, index) {[(t[1], t[3]) for t in got][:12]} against "
            f"{[(t[1], t[3]) for t in want][:12]}")
    dq = max((abs(a[2] - b[2]) for a, b in zip(got, want)), default=0.0)
    if dq > q_tol:
        raise AssertionError(f"[tracking] {what}: sync quality differs by "
                             f"{dq:.3e}")
    return dq


def tracking_goldens(dev, card):
    """(b) rx_batch and StreamingDemodulator on the card on the golden
    captures: the reference's frames byte for byte, and the tuples of the
    same receiver on the host."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from opv_tpu_torch.rx.pipeline import rx_batch
    from opv_tpu_torch.stream import StreamingDemodulator
    t0 = time.perf_counter()
    for name, gold in (("bert3", "bert3.frames"), ("raw3", "raw3.bin")):
        out = rx_batch(capture(name), device=dev)
        got = [bytes(f) for f in out["frames"]]
        if got != golden_frames(gold) or out["perfect"] != len(got):
            raise AssertionError(f"[tracking] (b) rx_batch {name}: "
                                 f"{len(got)} frames, {out['perfect']} "
                                 f"perfect, golden {gold} byte-equal "
                                 f"{got == golden_frames(gold)}")
    batch_s = time.perf_counter() - t0
    jobs = [(name, opts) for name, _, opts in TRACK_GOLDENS]
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(min(len(jobs), 8), mp_context=ctx) as pool:
        cpu_runs = pool.map(cpu_streaming, jobs)
        card_runs, card_s = [], 0.0
        for name, opts in jobs:
            t1 = time.perf_counter()
            sd = StreamingDemodulator(device=dev, **opts)
            card_runs.append(sd.feed(capture(name)) + sd.flush())
            card_s += time.perf_counter() - t1
        cpu_runs = list(cpu_runs)
    both_s = time.perf_counter() - t0
    dq = 0.0
    for (name, gold, opts), got, want in zip(TRACK_GOLDENS, card_runs,
                                             cpu_runs):
        what = f"(b) StreamingDemodulator {name} {opts or ''}".strip()
        if [t[0] for t in got] != golden_frames(gold):
            raise AssertionError(f"[tracking] {what}: the card's frames are "
                                 f"not {gold} ({len(got)} frames against "
                                 f"{len(golden_frames(gold))})")
        dq = max(dq, same_tracking(got, want, what + " card vs cpu"))
    n = sum(len(r) for r in card_runs)
    log(f"[tracking] (b) rx_batch on the card: bert3.frames and raw3.bin "
        f"byte for byte ({batch_s:.1f} s); StreamingDemodulator on the card: "
        f"the nine golden checks of tests/test_streaming.py byte for byte "
        f"({n} frames, {card_s:.1f} s host clock), every tuple equal to the "
        f"host's, largest sync-quality difference {dq:.3e} ({both_s:.1f} s "
        f"with the host runs in parallel) ({card})")
    return dict(batch_s=batch_s, card_s=card_s, frames=n, max_q_diff=dq)


def tracking_feed(dev):
    """(C, N) complex128 on the card: channel c is capture c % 7 of
    TRACK_CAPTURES after (c // 7) * TRACK_LEAD_STEP zero samples, zero
    padded at the end to the longest channel."""
    import torch
    caps = [capture(n) for n in TRACK_CAPTURES]
    leads = [(c // len(caps)) * TRACK_LEAD_STEP for c in range(TRACK_CHANNELS)]
    n = max(lead + len(caps[c % len(caps)]) for c, lead in enumerate(leads))
    x = torch.zeros((TRACK_CHANNELS, n), dtype=torch.complex128, device=dev)
    for c, lead in enumerate(leads):
        s = caps[c % len(caps)]
        x[c, lead:lead + len(s)] = torch.from_numpy(s).to(dev)
    return x


def tracking_64(dev, card, dtype: str = "float64"):
    """(c) MultiChannelTrackingDemodulator(channels=64, dtype) over the
    golden mix fed a chunk of air at a time: every channel's tuples equal a
    single-channel StreamingDemodulator on the card on that channel's
    samples (at float32 given the channel's CFO estimate: the batched and
    the single complex64 grid may round the flat curve's argmax apart),
    channels 0-6 the reference's frames; host ms per chunk, the kernels'
    device ms per chunk (torch.profiler), peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.stream import (MultiChannelTrackingDemodulator,
                                      StreamingDemodulator)
    x = tracking_feed(dev)
    n = x.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mc = MultiChannelTrackingDemodulator(TRACK_CHANNELS, device=dev,
                                         dtype=dtype)
    res, times = [], []
    before = registry.launch_counts()
    prof_at = (3, 6)            # the profiled chunks, not in the times
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    whole = n // SPF
    for k in range(whole):
        if k == prof_at[0]:
            prof.__enter__()
        t0 = time.perf_counter()
        res += mc.feed(x[:, k * SPF:(k + 1) * SPF])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if k == prof_at[1] - 1:
            prof.__exit__(None, None, None)
    after = registry.launch_counts()
    per_chunk = {k: (after[k] - before[k]) / whole for k in after
                 if after[k] > before[k]}
    res += mc.feed(x[:, whole * SPF:]) + mc.flush()
    peak = torch.cuda.max_memory_allocated()
    steady = [t for k, t in enumerate(times)
              if k >= 1 and not prof_at[0] <= k < prof_at[1]]
    ms_chunk = statistics.median(steady)
    msps = TRACK_CHANNELS * SPF / ms_chunk / 1e3
    chunks = prof_at[1] - prof_at[0]
    dev_ms, dev_n = Counter(), Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        key = next((k for k in ("track_symbols", "sync_scan", "viterbi")
                    if k in e.key), "other")
        dev_ms[key] += e.self_device_time_total / 1e3 / chunks
        dev_n[key] += e.count / chunks
    # the JAX contract: each channel equals its own single-channel run
    t0 = time.perf_counter()
    dq = 0.0
    tag = "tracking" if dtype == "float64" else "precision"
    for c in range(TRACK_CHANNELS):
        pin = {} if dtype == "float64" else \
            {"init_offset": float(mc.est_offset[c])}
        sd = StreamingDemodulator(device=dev, dtype=dtype, **pin)
        single = sd.feed(x[c]) + sd.flush()
        mine = [t[1:] for t in res if t[0] == c]
        dq = max(dq, same_tracking(mine, single, f"(c) {dtype} channel {c}"))
        if c < len(TRACK_CAPTURES):
            # the reference's frames; past them only frames that end after
            # the capture does (the flywheel completes one from the zeros)
            gold = golden_frames(TRACK_GOLDENS[c][1])
            end = len(capture(TRACK_CAPTURES[c])) // 40
            if [t[0] for t in mine[:len(gold)]] != gold \
                    or any(t[3] < end for t in mine[len(gold):]):
                raise AssertionError(
                    f"[{tag}] (c) {dtype} channel {c}: not "
                    f"{TRACK_GOLDENS[c][1]}, then frames past the capture's "
                    f"end ({[(t[1], t[3]) for t in mine]})")
    singles_s = time.perf_counter() - t0
    log(f"[{tag}] (c) tracking-64 at {dtype}: {len(res)} frames over "
        f"{TRACK_CHANNELS} channels x {n} samples ({len(times)} feeds of a "
        f"chunk, then the tail and flush); every channel equal to its own StreamingDemodulator on the "
        f"card (largest sync-quality difference {dq:.3e}; the single runs "
        f"{singles_s:.1f} s), channels 0-6 the reference's frames (then "
        f"only frames ending past the capture, in its zero padding); "
        f"{ms_chunk:.2f} ms per chunk after the first (median; "
        f"{min(steady):.2f}-{max(steady):.2f}) = {msps:.1f} Msamples/s = "
        f"{msps / (TRACK_CHANNELS * REAL_TIME_MSPS):.2f}x real time for "
        f"{TRACK_CHANNELS} channels; device ms per chunk (torch.profiler, "
        f"{chunks} chunks): {', '.join(f'{k} {v:.3f}' for k, v in dev_ms.most_common())}; "
        f"device kernels per chunk {sum(dev_n.values()):.1f} "
        f"({', '.join(f'{k} {v:.1f}' for k, v in dev_n.most_common())}); "
        f"the port's kernels' launches per chunk {per_chunk}; "
        f"peak memory {peak / 2**30:.2f} GiB ({card})")
    return dict(dtype=dtype, frames=len(res), ms_per_chunk=ms_chunk,
                chunk_ms=times, msps=msps,
                x_real_time=msps / (TRACK_CHANNELS * REAL_TIME_MSPS),
                device_ms_per_chunk=dict(dev_ms),
                device_kernels_per_chunk=dict(dev_n),
                launches_per_chunk=per_chunk, peak_bytes=peak,
                max_q_diff=dq)


TRANSITIONS = [
    "[23] HUNTING→VERIFYING (corr=1.000, raw=5824282519967)",
    "[2167] VERIFYING→LOCKED (frame 1)",
    "[2191] LOCKED: sync OK (corr=1.000)",
    "[4359] LOCKED: sync OK (corr=1.000)",
    "[6527] LOCKED: sync MISS #1 (corr=0.000)",
]


def tracking_cli(card, fast_echo: dict):
    """(d) the CLIs' tracking modes on the card: opv_demod batch and -s in
    this process, opv_modem -l without --fast as a process."""
    from opv_tpu_torch.cli import opv_demod
    from opv_tpu_torch.core.framing import build_bert_frame
    runs = [(["-r", "-q"], "bert3.iq", "bert3.frames"),
            (["-r", "-q"], "raw3.iq", "raw3.bin"),
            (["-s", "-r", "-q"], "awgn8.iq", "awgn8.frames"),
            (["-s", "-r", "-q"], "dropout.iq", "dropout.frames")]
    t0 = time.perf_counter()
    for argv, iq, gold in runs:
        rc, out, err = run_main(opv_demod.main, argv, golden(iq))
        if rc != 0 or out != golden(gold):
            raise AssertionError(f"[tracking] (d) opv_demod {argv} < {iq}: rc "
                                 f"{rc}, {len(out)} bytes, == {gold} "
                                 f"{out == golden(gold)}; {err[-500:]}")
    rc, _, err = run_main(opv_demod.main, ["-s"], golden("bert3.iq"))
    lines = [ln for ln in err.splitlines()
             if "HUNTING" in ln or "VERIFYING" in ln or "LOCKED:" in ln]
    if rc != 0 or lines[:5] != TRANSITIONS:
        raise AssertionError(f"[tracking] (d) opv_demod -s < bert3.iq: rc "
                             f"{rc}, transition lines {lines[:5]}")
    demod_s = time.perf_counter() - t0
    frames = [bytes(f) for f in build_bert_frame(
        "W5NYV", frame_num=np.arange(CLI_ECHO_WARM + CLI_ECHO_FRAMES))]
    n_back, cold, lat = modem_echo(["-l"], frames)
    p50, p95 = lat[len(lat) // 2], lat[int(0.95 * (len(lat) - 1))]
    log(f"[tracking] (d) opv_demod batch -r -q: bert3.frames and raw3.bin; "
        f"-s -r -q: awgn8.frames and dropout.frames, byte for byte; -s on "
        f"bert3.iq: the reference's five transition lines ({demod_s:.1f} s "
        f"in this process); opv_modem -l (tracking demodulator, exact TX) "
        f"echoed {n_back}/{len(frames)} frames sent every "
        f"{CLI_PACING_S * 1e3:.0f} ms byte-equal: the first {cold:.1f} ms "
        f"after it was sent, then over {len(lat)} frames after "
        f"{CLI_ECHO_WARM} of warm-up echo p50 {p50:.2f} ms p95 {p95:.2f} ms "
        f"(host clock), against -l --fast's p50 "
        f"{fast_echo['echo_p50_ms']:.2f} ms p95 "
        f"{fast_echo['echo_p95_ms']:.2f} ms in phase 9 ({card})")
    return dict(demod_s=demod_s, echo_frames=n_back, echo_first_ms=cold,
                echo_p50_ms=p50, echo_p95_ms=p95, echo_ms=lat)


def phase_tracking(dev, card, int_ops_per_s: float, fast_echo: dict):
    """The reference-parity tracking receiver on the card (phase 11)."""
    import torch
    from opv_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    kernels = tracking_kernels(dev, card, int_ops_per_s)
    routes = sync_routes(dev, card)
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    goldens = tracking_goldens(dev, card)
    mc = tracking_64(dev, card)
    cli = tracking_cli(card, fast_echo)
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    if min(launches[k] for k in ("track_symbols", "sync_scan[SoftSync]",
                                 "viterbi_r4")) <= 0 \
            or launches["sync_scan[GivenSync]"] \
            or routes["sync_scan[GivenSync]"] <= 0:
        raise AssertionError(f"[tracking] a kernel of the tracking path never "
                             f"launched, or GivenSync launched on it: "
                             f"{launches}; the GivenSync route: {routes}")
    log(f"[tracking] launches over (b)-(d) {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, routes_launches=routes, kernels=kernels,
                goldens=goldens, tracking_64=mc, cli=cli)


DENSE_KEYS = ("frames", "metrics", "frame_valid", "sync_q", "starts",
              "freq_offset")


def dense_host(out: dict) -> dict:
    """An rx_fast result's arrays as numpy."""
    return {k: out[k].cpu().numpy() for k in DENSE_KEYS}


def same_dense(got: dict, want: dict, raw: np.ndarray, what: str):
    """Two rx_fast results (dense_host) of the same samples and CFO: equal
    validity; per slot the same start, or one sample away at a plateau tie
    of `raw` (got's run's raw correlation, (C, M)) in a slot valid in
    both; frame bytes equal and metrics equal where the start is, unless
    both metrics exceed WB_LEAK_METRIC (garbage decoded at a signal edge
    or from leakage, whose bits float order moves); sync quality within
    DENSE_Q_TOL (WB_GARBAGE_Q_TOL for garbage).  Returns (ties, garbage
    slots that differ)."""
    off = 24 * 40
    if not np.array_equal(got["frame_valid"], want["frame_valid"]):
        raise AssertionError(f"{what}: frame_valid differs")
    ties = differ = 0
    for c, k in np.ndindex(got["starts"].shape):
        a, b = int(got["starts"][c, k]), int(want["starts"][c, k])
        ma, mb = int(got["metrics"][c, k]), int(want["metrics"][c, k])
        garbage = min(ma, mb) > WB_LEAK_METRIC
        same = (ma == mb and np.array_equal(got["frames"][c, k],
                                            want["frames"][c, k]))
        if a != b:
            ra, rb = raw[c, a - off], raw[c, b - off]
            if abs(a - b) != 1 or not want["frame_valid"][c, k] \
                    or abs(ra - rb) > DENSE_PLATEAU_RTOL * abs(ra):
                raise AssertionError(f"{what}: channel {c} slot {k} starts "
                                     f"{a} / {b}, raw {ra} / {rb}")
            ties += 1
            same = np.array_equal(got["frames"][c, k], want["frames"][c, k])
        if not same:
            if not garbage:
                raise AssertionError(f"{what}: channel {c} slot {k} at {a}: "
                                     f"metrics {ma} / {mb}, frames equal "
                                     f"{np.array_equal(got['frames'][c, k], want['frames'][c, k])}")
            differ += 1
        dq = abs(float(got["sync_q"][c, k]) - float(want["sync_q"][c, k]))
        if dq > (WB_GARBAGE_Q_TOL if garbage else DENSE_Q_TOL):
            raise AssertionError(f"{what}: channel {c} slot {k}: sync "
                                 f"quality differs by {dq:.3g}")
    return ties, differ


def same_dense_tuples(got, want, what: str) -> int:
    """Two MultiChannelDemodulator tuple streams whose blocks agreed by
    same_dense: the same count and channels, positions within one sample
    (a plateau tie), bytes and metric equal where the position is (unless
    both metrics exceed WB_LEAK_METRIC), sync quality within DENSE_Q_TOL
    (WB_GARBAGE_Q_TOL for garbage).  Returns how many positions differ."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tuples against {len(want)}")
    ties = 0
    for g, w in zip(got, want):
        garbage = min(g[2], w[2]) > WB_LEAK_METRIC
        ties += g[4] != w[4]
        if g[0] != w[0] or abs(g[4] - w[4]) > 1 or (
                g[4] == w[4] and (g[1], g[2]) != (w[1], w[2])
                and not garbage) \
                or abs(g[3] - w[3]) > (WB_GARBAGE_Q_TOL if garbage
                                       else DENSE_Q_TOL):
            raise AssertionError(f"{what}: tuple {(g[0], g[2], g[3], g[4])} "
                                 f"against {(w[0], w[2], w[3], w[4])}")
    return ties


def check_dense_frames(got, want, what: str):
    """got [(sync position, metric, bytes)] of one channel against the
    transmitted want [(sync position, bytes)]: the same count, each frame
    byte-exact at its position or one sample away (the plateau), metric 0
    at its position and at most DENSE_LATE_METRIC one sample away.
    Returns (frames at their exact position, frames with metric 0)."""
    got = sorted(got)
    want = sorted(want)
    if len(got) != len(want) or any(
            g[2] != w[1] or abs(g[0] - w[0]) > 1
            or g[1] > (0 if g[0] == w[0] else DENSE_LATE_METRIC)
            for g, w in zip(got, want)):
        raise AssertionError(f"{what}: {[(int(g[0]), int(g[1])) for g in got]}"
                             f" against positions {[w[0] for w in want]}")
    return (sum(g[0] == w[0] for g, w in zip(got, want)),
            sum(g[1] == 0 for g in got))


class dense_blocks:
    """Wrap the rx_fast of stream/multichannel.py, the block step of every
    MultiChannelDemodulator (WidebandReceiver(engine="fast") included).
    With record (a list): each block's results are appended (dense_host).
    With replay (such a list, from a run on the same blocks, each result
    sliced to this run's channels): each block runs with the recorded CFO
    estimate, and its slots are held to the record by same_dense on this
    run's raw correlation.  `stats` counts blocks, ties and differing
    garbage slots."""

    def __init__(self, record=None, replay=None, what: str = "dense"):
        self.record, self.replay, self.what = record, replay, what
        self.stats = dict(blocks=0, ties=0, garbage_differing=0)

    def __enter__(self):
        from opv_tpu_torch.stream import multichannel
        self._real = real = multichannel.rx_fast

        def step(block, max_frames):
            i = self.stats["blocks"]
            self.stats["blocks"] += 1
            if self.replay is None:
                out = real(block, max_frames=max_frames)
                self.record.append(dense_host(out))
                return out
            import torch
            from opv_tpu_torch.rx.fast import dense_soft, dense_sync
            want = self.replay[i]
            foff = torch.from_numpy(want["freq_offset"]).to(block.device)
            out = real(block, foff, max_frames=max_frames)
            raw = dense_sync(dense_soft(block, foff))[0].cpu().numpy()
            t, d = same_dense(dense_host(out), want, raw,
                              f"{self.what} block {i}")
            self.stats["ties"] += t
            self.stats["garbage_differing"] += d
            return out
        multichannel.rx_fast = step
        return self.stats

    def __exit__(self, *exc):
        from opv_tpu_torch.stream import multichannel
        multichannel.rx_fast = self._real
        if exc[0] is None and self.replay is not None \
                and self.stats["blocks"] != len(self.replay):
            raise AssertionError(f"{self.what}: {self.stats['blocks']} blocks "
                                 f"replayed of {len(self.replay)} recorded")


def keep_first_call(obj, name: str, held: dict):
    """Wrap obj.name so that its first call's arguments are kept (tensors
    cloned) in held[name].  Returns a function that removes the wrap."""
    import torch
    fn = getattr(obj, name)

    def call(*a):
        held.setdefault(name, tuple(v.clone() if isinstance(v, torch.Tensor)
                                    else v for v in a))
        return fn(*a)
    setattr(obj, name, call)
    return lambda: setattr(obj, name, fn)


def dense_smoke(x, frames, delays, dev, card):
    """(a) rx_fast on smoke-64x20: every frame whose payload fits valid,
    byte-exact, metric 0, at its start (+-1 sample); time per call, device
    time by stage and by kernel, peak memory.  Returns (stats, the first
    Viterbi call's operands, the launches of the stage timings, which are
    not runs of the path)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.ops import viterbi as vit
    from opv_tpu_torch.rx import fast
    from opv_tpu_torch.rx.cfo import estimate_cfo_batch
    from opv_tpu_torch.rx.frame_decoder import decode_payloads, quantize_soft
    c, n = x.shape
    mf = DENSE_MAX_FRAMES
    held = {}
    remove = keep_first_call(registry, "viterbi_batch", held)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fast.rx_fast(x, max_frames=mf)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    remove()
    r = dense_host(out)
    m_soft = n - 39
    fits = [[d + k * SPF for k in range(FRAMES)
             if d + k * SPF + 960 + 2143 * 40 < m_soft] for d in delays]
    want_frames = [bytes(f) for f in frames.cpu().numpy()]
    exact = metric0 = 0
    for ch, starts in enumerate(fits):
        fv = r["frame_valid"][ch]
        e, m0 = check_dense_frames(
            list(zip((int(p) for p in r["starts"][ch][fv] - 960),
                     (int(m) for m in r["metrics"][ch][fv]),
                     (bytes(f) for f in r["frames"][ch][fv]))),
            [(p, want_frames[k]) for k, p in enumerate(starts)],
            f"dense (a) channel {ch}")
        exact += e
        metric0 += m0
    n_fit = sum(len(f) for f in fits)
    ms = median_ms(lambda: fast.rx_fast(x, max_frames=mf), DENSE_REPS)
    # device ms by stage (CUDA events on this call's intermediates)
    foff = out["freq_offset"]
    soft = fast.dense_soft(x, foff)
    raw, norm = fast.dense_sync(soft)
    starts, _, _ = fast.detect_frames(raw, norm, soft, mf)
    pay = fast.extract_payloads_dense(soft, starts).reshape(-1, 2144)
    q, _ = quantize_soft(pay)
    stages = {
        "estimate_cfo_batch": lambda: estimate_cfo_batch(x),
        "dense_soft": lambda: fast.dense_soft(x, foff),
        "dense_sync": lambda: fast.dense_sync(soft),
        "detect_frames": lambda: fast.detect_frames(raw, norm, soft, mf),
        "extract_payloads_dense": lambda: fast.extract_payloads_dense(soft,
                                                                      starts),
        "decode_payloads": lambda: decode_payloads(pay),
    }
    before = registry.launch_counts()
    stage_ms = {k: cuda_ms(f, 3) for k, f in stages.items()}
    vit_ms = cuda_ms(lambda: vit.viterbi_r4_cuda(q), 3)
    after = registry.launch_counts()
    timing_launches = {k: after[k] - before[k] for k in after}
    del soft, raw, norm
    # device ms by kernel over one call
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fast.rx_fast(x, max_frames=mf)
        torch.cuda.synchronize(dev)
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(t for t, _, _ in kernels) / 1e3
    log(f"[dense] (a) rx_fast on smoke-{c}x{FRAMES} (N={n}, max_frames {mf}):"
        f" {n_fit}/{n_fit} frames whose payload fits valid and byte-exact, "
        f"{exact} at their sync start with metric 0, the rest one sample "
        f"late (the plateau; {metric0} with metric 0 in all); "
        f"{int(out['n_decoded'])} decoded; "
        f"{ms:.3f} ms a call (CUDA events, median of {DENSE_REPS}) = "
        f"{c * n / ms / 1e3:.1f} Msamples/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({card})")
    log("[dense] (a) device ms by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items())
        + f"; the Viterbi kernel alone at B={q.shape[0]} {vit_ms:.4f}")
    log(f"[dense] (a) torch.profiler, one call: device busy {busy:.3f} ms, "
        f"{sum(k for _, k, _ in kernels)} kernels")
    for t, k, key in kernels[:12]:
        log(f"[dense]   {t / 1e3:8.4f} ms {k:4d}x  {key[:90]}")
    return dict(frames_fit=n_fit, at_start=exact, metric0=metric0,
                decoded=int(out["n_decoded"]), ms=ms, stage_ms=stage_ms,
                viterbi_ms=vit_ms, profiler_busy_ms=busy,
                profiler_kernels=[(key[:90], t / 1e3, k)
                                  for t, k, key in kernels[:12]],
                peak_bytes=peak), held["viterbi_batch"], timing_launches


def dense_stream(x, frames, delays, dev, card):
    """(b) MultiChannelDemodulator(64, block_frames 4) on the stream
    phase's feed: channels 0-55 every frame once, byte-exact, metric 0, at
    its position (+-1); the gap-burst channels' tuples equal to the same
    receiver on the cpu given the card's CFO estimates; host ms per block,
    Msamples/s, multiple of real time, peak memory."""
    import torch
    from opv_tpu_torch.stream import MultiChannelDemodulator
    feed, want = stream_feed(x, frames, delays, dev)
    c, n = feed.shape
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mc = MultiChannelDemodulator(c, block_frames=DENSE_BF, device=dev)
    cuts = [0, mc.window] + list(range(mc.window + mc.advance, n,
                                       mc.advance)) + [n]
    out, blocks = [], []
    t_all = time.perf_counter()
    for a, b in zip(cuts, cuts[1:]):
        nb = mc._abs_base
        t0 = time.perf_counter()
        out += mc.feed(feed[:, a:b])
        torch.cuda.synchronize(dev)
        if mc._abs_base == nb + mc.advance:       # one block completed
            blocks.append((time.perf_counter() - t0) * 1e3)
    out += mc.flush()
    dt = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated(dev)
    exact = metric0 = 0
    for ch in range(STREAM_CLEAN):
        e, m0 = check_dense_frames(
            [(r[4], r[2], r[1]) for r in out if r[0] == ch],
            [(p, bytes(f.cpu().numpy())) for f, p in want[ch]],
            f"dense (b) channel {ch}")
        exact += e
        metric0 += m0
    # the gap-burst channels: a run on the card recording each block, its
    # tuples equal to the timed run's; then the cpu on those channels given
    # each block's card CFO estimate, held block by block and tuple by tuple
    burst = slice(STREAM_CLEAN, c)
    record = []
    with dense_blocks(record=record):
        card_run = MultiChannelDemodulator(c, block_frames=DENSE_BF,
                                           device=dev)
        rec_out = card_run.feed(feed) + card_run.flush()
    same_dense_tuples(rec_out, out, "dense (b) recorded run vs timed run")
    mine = [(r[0] - STREAM_CLEAN,) + r[1:] for r in rec_out
            if r[0] >= STREAM_CLEAN]
    sliced = [{k: v[burst] for k, v in blk.items()} for blk in record]
    with dense_blocks(replay=sliced, what="dense (b) cpu") as st:
        mcc = MultiChannelDemodulator(c - STREAM_CLEAN, block_frames=DENSE_BF,
                                      device="cpu")
        cpu_out = mcc.feed(feed[burst].cpu()) + mcc.flush()
    ties = same_dense_tuples(mine, cpu_out, "dense (b) card vs cpu")
    sent = [{bytes(f.cpu().numpy()) for f, _ in w} for w in want[burst]]
    n_sent = sum(len(w) for w in sent)
    burst_true = sum(r[1] in sent[r[0]] for r in mine)
    msps = c * n / dt / 1e6
    log(f"[dense] (b) MultiChannelDemodulator({c}, block_frames {DENSE_BF}) "
        f"on the stream feed ({n} samples a channel, {len(blocks)} "
        f"block-sized feeds after the first window, then flush): "
        f"channels 0-{STREAM_CLEAN - 1} every frame once, byte-exact, at its "
        f"position ({exact} exactly, with metric 0) or one sample late "
        f"({metric0} with metric 0 in all); channels {STREAM_CLEAN}-{c - 1}: "
        f"{len(mine)} tuples ({burst_true} of {n_sent} transmitted frames"
        f") equal to the cpu's given the card's CFO ({st['blocks']} blocks, "
        f"{st['ties']} plateau ties, {ties} positions one sample apart, "
        f"{st['garbage_differing']} garbage slots differing in bits); host ms"
        f" per block {statistics.median(blocks):.3f} (median; "
        f"{min(blocks):.3f}-{max(blocks):.3f}); {msps:.1f} Msamples/s = "
        f"{msps / (c * REAL_TIME_MSPS):.2f} x real time; peak memory "
        f"{peak / 2**30:.2f} GiB ({card})")
    return dict(tuples=len(out), at_position=exact, metric0=metric0,
                burst_tuples=len(mine),
                burst_true=burst_true, burst_sent=n_sent,
                blocks=st["blocks"], ties=st["ties"], tuple_ties=ties,
                ms_per_block=blocks, seconds=dt, msamples_s=msps,
                x_real_time=msps / (c * REAL_TIME_MSPS), peak_bytes=peak)


def dense_wideband(dev, card):
    """(c) WidebandReceiver(engine="fast") on the wideband phase's
    carriers at the wire level: the frames decoded against those sent and
    ms per quantum beside the locked engine's on the same feed; a K =
    DENSE_CUT_K cut of the carriers, card tuples against the cpu's given
    the card's CFO."""
    import torch
    from opv_tpu_torch.stream import WidebandReceiver
    x, frames = wideband_feed(dev)
    x = x * WB_WIRE_GAIN
    n_sent = sum(len(f) for f in frames)
    owner = {b: ch for ch, fs in enumerate(frames) for b in fs}
    res = {}
    for engine in ("fast", "locked"):
        rx = WidebandReceiver(WB_K, block_frames=WB_BF, engine=engine,
                              device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = drive_wideband(rx, x)
        dt = time.perf_counter() - t0
        true = [r for r in out if r[1] in owner]
        res[engine] = dict(
            tuples=len(out), frames=len({r[1] for r in true}),
            duplicates=len(true) - len({r[1] for r in true}),
            wrong_channel=sum(owner[r[1]] != r[0] for r in true),
            garbage=len(out) - len(true),
            ms_per_quantum=dt * 1e3 * rx.quantum / x.shape[0],
            seconds=dt)
        del out, true
    f, lk = res["fast"], res["locked"]
    log(f"[dense] (c) WidebandReceiver(engine='fast') K={WB_K}, block_frames "
        f"{WB_BF}, the wideband carriers x {WB_WIRE_GAIN:.5f} ({x.shape[0]} "
        f"samples): {f['frames']}/{n_sent} frames decoded "
        f"({f['duplicates']} twice, {f['wrong_channel']} on another channel, "
        f"{f['garbage']} garbage tuples); {f['ms_per_quantum']:.3f} ms per "
        f"quantum on the host clock, the locked engine on the same feed "
        f"{lk['ms_per_quantum']:.3f} ms ({lk['frames']}/{n_sent} frames) "
        f"({card})")
    if f["wrong_channel"]:
        raise AssertionError(f"dense (c): frames on another channel {f}")
    del x
    k = DENSE_CUT_K
    xk, frames_k = wideband_feed(dev, k)
    xk = xk * (32767.0 / (k * 16383.0))
    record = []
    with dense_blocks(record=record):
        got = drive_wideband(WidebandReceiver(k, block_frames=WB_BF,
                                              engine="fast", device=dev), xk)
    with dense_blocks(replay=record, what=f"dense (c) K={k} cpu") as st:
        want = drive_wideband(WidebandReceiver(k, block_frames=WB_BF,
                                               engine="fast", device="cpu"),
                              xk.cpu())
    ties = same_dense_tuples(got, want, f"dense (c) K={k} card vs cpu")
    sent_k = {b for fs in frames_k for b in fs}
    res["cut"] = dict(k=k, tuples=len(got), blocks=st["blocks"],
                      ties=st["ties"], tuple_ties=ties,
                      garbage_differing=st["garbage_differing"],
                      frames=len({r[1] for r in got if r[1] in sent_k}),
                      sent=len(sent_k))
    log(f"[dense] (c) K={k} cut of the same carriers: card tuples equal to "
        f"the cpu's given the card's CFO ({len(got)} tuples, "
        f"{res['cut']['frames']}/{len(sent_k)} frames; {st['blocks']} blocks, "
        f"{st['ties']} plateau ties, {st['garbage_differing']} garbage slots "
        f"differing in bits)")
    return res


def dense_cli(dev, card):
    """(d) the CLIs in this process: opv_demod --fast -r -q on bert3 and
    raw3 (the goldens), opv_demod -c on bert3 (the reference's report, rc
    1); the coherent loop's ms per symbol on the card, and its soft values
    against the cpu's.  Returns (stats, the first SoftSync call's
    operands)."""
    import torch
    from opv_tpu_torch.cli import opv_demod
    from opv_tpu_torch.ops import registry
    from opv_tpu_torch.rx.coherent import (coherent_state_init,
                                           demodulate_coherent, pll_gains)
    from opv_tpu_torch.config import CONFIG
    for iq, gold in (("bert3.iq", "bert3.frames"), ("raw3.iq", "raw3.bin")):
        rc, out, err = run_main(opv_demod.main, ["--fast", "-r", "-q"],
                                golden(iq))
        if rc != 0 or out != golden(gold):
            raise AssertionError(f"dense (d) opv_demod --fast < {iq}: rc {rc},"
                                 f" {len(out)} bytes; {err[-500:]}")
    held = {}
    remove = keep_first_call(registry, "sync_correlate_scan", held)
    t0 = time.perf_counter()
    rc, out, err = run_main(opv_demod.main, ["-c"], golden("bert3.iq"))
    cli_s = time.perf_counter() - t0
    remove()
    missing = [ln for ln in COHERENT_LINES if ln not in err]
    if rc != 1 or out or missing:
        raise AssertionError(f"dense (d) opv_demod -c < bert3.iq: rc {rc}, "
                             f"missing {missing}")
    s = torch.from_numpy(capture("bert3"))
    a, b = pll_gains(50.0)

    def loop(dev_):
        st = coherent_state_init(1430.0, device=dev_)
        return demodulate_coherent(s.to(dev_), st, CONFIG.afc_alpha, a, b)
    loop(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    soft_d, st_d = loop(dev)
    torch.cuda.synchronize(dev)
    loop_s = time.perf_counter() - t0
    soft_c, st_c = loop("cpu")
    nsym = soft_c.shape[0]
    k = COHERENT_SYMBOLS
    err_k = float((soft_d[:k].cpu() - soft_c[:k]).abs().max()
                  / soft_c[:k].abs().max())
    err_all = float((soft_d.cpu() - soft_c).abs().max() / soft_c.abs().max())
    if not err_k <= COHERENT_RTOL:
        raise AssertionError(f"dense (d) coherent loop: card vs cpu {err_k:.3g}"
                             f" of max|soft| over {k} symbols")
    air_s = s.shape[0] / CONFIG.sample_rate
    log(f"[dense] (d) opv_demod --fast -r -q: bert3.frames and raw3.bin byte "
        f"for byte; opv_demod -c < bert3.iq: the reference's report (1430.0 "
        f"Hz, 6604 symbols, AFC 2000.0 Hz, 0 frames, HUNTING), rc 1, "
        f"{cli_s:.2f} s in this process; the coherent loop on the card "
        f"{loop_s * 1e3:.1f} ms for {nsym} symbols = "
        f"{loop_s * 1e3 / nsym:.4f} ms a symbol against {air_s:.3f} s of "
        f"air ({air_s / loop_s:.3f} x real time); soft card vs cpu "
        f"{err_k:.3g} of max|soft| over {k} symbols, {err_all:.3g} over all; "
        f"final AFC card {float(st_d.freq_offset):.1f} / cpu "
        f"{float(st_c.freq_offset):.1f} Hz ({card})")
    return dict(cli_coherent_s=cli_s, loop_ms=loop_s * 1e3,
                loop_ms_per_symbol=loop_s * 1e3 / nsym, symbols=nsym,
                air_s=air_s, soft_rel_err=err_k,
                soft_rel_err_all=err_all), held["sync_correlate_scan"]


def phase_dense(dev, card):
    """The feed-forward dense receiver and the coherent demodulator on the
    card (phase 12)."""
    import torch
    from opv_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    x, frames, delays = synthesize(dev)
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    a, vit_ops, timing_launches = dense_smoke(x, frames, delays, dev, card)
    b = dense_stream(x, frames, delays, dev, card)
    del x
    c = dense_wideband(dev, card)
    d, sync_ops = dense_cli(dev, card)
    torch.cuda.synchronize(dev)
    launches = {k: v - timing_launches[k]
                for k, v in registry.launch_counts().items()}
    if min(launches["viterbi_r4"], launches["sync_scan[SoftSync]"]) <= 0:
        raise AssertionError(f"a kernel of the dense phase never launched: "
                             f"{launches}")
    # each kernel's first call of the phase against its twin, after the
    # count
    _, _, err = hold_viterbi(vit_ops[0], 4, "dense (a)")
    hold_sync_soft(*sync_ops, "dense (d) opv_demod -c")
    held = dict(viterbi_r4=dict(shape=list(vit_ops[0].shape),
                                max_abs_err=err),
                sync_scan_soft=dict(shape=list(sync_ops[0].shape)))
    log(f"[dense] rx_fast's Viterbi call {list(vit_ops[0].shape)} and "
        f"opv_demod -c's SoftSync call {list(sync_ops[0].shape)} "
        f"bit-identical to their twins")
    log(f"[dense] launches over (a)-(d) {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, a=a, b=b, c=c, d=d, held=held)


def precision_kernels(dev, card, int_ops_per_s: float):
    """(a) track_symbols[float32] and both sync_scan[float32]
    instantiations against their twins at C = 1 and C = TRACK_CHANNELS on
    one chunk of the golden mix (complex64), each timed in turns with its
    float64 instantiation on the same chunk (complex128); track_symbols
    [float32] on TRACK_EDGE_CASES and TRACK_F32_EDGE_CASES, sync_scan
    [float32] on the stress inputs and SYNC_EDGE_CASES (as float32, so
    norms sit exactly on the rounded thresholds)."""
    import torch
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.ops import sync_scan as sc
    from opv_tpu_torch.ops import track_symbols as ts
    from opv_tpu_torch.rx.demod import max_symbols
    from opv_tpu_torch.rx.sync import sync_correlate
    eb = CONFIG.encoded_bits
    maxs = max_symbols(SPF)
    f32 = torch.float32
    rows = {}
    for c in (1, TRACK_CHANNELS):
        x, nv, state = track_inputs(c, dev, f32)
        x64, _, state64 = track_inputs(c, dev)
        (soft, valid, _, _), err, twin_ms = hold_track(x, nv, state,
                                                       f"float32 C={c}")

        def t1(xs, st):
            return lambda: ts.track_symbols_cuda(xs, nv, st, CONFIG.afc_alpha,
                                                 maxs)
        # in turns: float32, float64, float64, float32
        turns = [cuda_ms(t1(*a), TRACK_REPS) for a in
                 ((x, state), (x64, state64), (x64, state64), (x, state))]
        ms, ms64 = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        nsym = int(valid.sum())
        b_ms, b_by = track_bound(nsym, int(nv.sum()), c, maxs, real_bytes=4)
        row = dict(ms=ms, plain_ms=twin_ms, max_abs_err=err, bound_ms=b_ms,
                   bound_by=b_by, roofline=b_ms / ms, library_ms=None,
                   float64_ms=ms64, turns_ms=turns, symbols=nsym)
        rows[c] = {"track_symbols[float32]": row}
        air_ms = SPF / REAL_TIME_MSPS / 1e3
        log(f"[precision] (a) C={c}: track_symbols[float32] n_sym, "
            f"samples_used and sym_valid equal to the twin's, soft within "
            f"{err:.3e} (max|soft| {float(soft.abs().max()):.3e}, tolerance "
            f"{TRACK_F32_RTOL:g} of it); {nsym} symbols: {ms:.3f} ms per "
            f"chunk against float64's {ms64:.3f} ms in turns "
            f"{[round(t, 3) for t in turns]} ({air_ms:.0f} ms of air, "
            f"{air_ms / ms:.1f}x real time), twin {twin_ms:.0f} ms (host), "
            f"bound {b_ms:.4f} ms ({b_by}) ({card})")
        ext = torch.cat([torch.zeros((c, eb), dtype=f32, device=dev), soft],
                        1)[:, eb - 23:]
        ext64 = ext.double()
        ints = torch.zeros((c, 6), dtype=torch.int32, device=dev)
        q0 = torch.zeros(c, dtype=f32, device=dev)
        raw, norm = sync_correlate(ext)
        _, given_twin_ms = hold_sync(raw, norm, valid, ints, q0,
                                     f"float32 C={c}")
        got, soft_twin_ms = hold_sync_soft(ext, valid, ints, q0,
                                           f"float32 C={c}")
        raw64, norm64 = sync_correlate(ext64)
        q64 = q0.double()
        timed = {}
        for name, fn, fn64, plain in (
                ("GivenSync",
                 lambda: sc.sync_scan_cuda(raw, norm, valid, ints, q0),
                 lambda: sc.sync_scan_cuda(raw64, norm64, valid, ints, q64),
                 given_twin_ms),
                ("SoftSync",
                 lambda: sc.sync_correlate_scan_cuda(ext, valid, ints, q0),
                 lambda: sc.sync_correlate_scan_cuda(ext64, valid, ints, q64),
                 soft_twin_ms)):
            turns = [device_ms(f, SYNC_REPS) for f in (fn, fn64, fn64, fn)]
            ms, ms64 = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            b_ms, b_by = sync_bound(c, maxs, int_ops_per_s,
                                    name == "SoftSync", real_bytes=4)
            rows[c][f"sync_scan[{name},float32]"] = dict(
                ms=ms, plain_ms=plain, max_abs_err=0.0, bound_ms=b_ms,
                bound_by=b_by, roofline=b_ms / ms, library_ms=None,
                float64_ms=ms64, turns_ms=turns)
            timed[name] = (ms, ms64, b_ms)
        log(f"[precision] (a) C={c}: sync_scan[float32] bit-identical, both "
            f"instantiations ({int(got[2].sum())} frames ready): "
            + ", ".join(f"{k} {v[0]:.4f} ms against float64's {v[1]:.4f} "
                        f"(bound {v[2]:.5f})" for k, v in timed.items())
            + f" ({card})")
    t0 = time.perf_counter()
    for name in TRACK_EDGE_CASES + TRACK_F32_EDGE_CASES:
        x, nv, state = track_edge_case(name, dev, f32)
        (_, valid, _, used), err, twin_ms = hold_track(x, nv, state,
                                                       f"float32 {name}")
        if name == "odd rows" and valid.sum(1).tolist()[2] < 20:
            raise AssertionError(f"[precision] odd rows: n_sym "
                                 f"{valid.sum(1).tolist()}")
        log(f"[precision] (a) track_symbols[float32] on {name} "
            f"({tuple(x.shape)}, n_valid {nv.tolist()[:4]}): n_sym "
            f"{valid.sum(1).tolist()[:4]} and samples_used "
            f"{used.tolist()[:4]} equal to the twin's, soft within "
            f"{err:.3e} (twin {twin_ms:.0f} ms)")
    stress = list(sync_stress(TRACK_CHANNELS, maxs, dev))
    # channels 5, 11, ... LOCKED with every norm on the locked threshold:
    # float32's 0.7 passes (EV_SYNC_OK) where a double compare would not
    stress[1][5::6] = CONFIG.sync_locked_norm_thresh
    stress[3][5::6, 1] = 1_000
    stress = [t.float() if t.dtype == torch.float64 else t for t in stress]
    (_, _, ready, _, events, _, _), _ = hold_sync(*stress, "float32 stress")
    on_thresh = (stress[1] == float(np.float32(CONFIG.sync_locked_norm_thresh))
                 ) & (events == 3)
    if not bool(on_thresh.any()):
        raise AssertionError("[precision] no locked check at the rounded "
                             "threshold in the float32 stress input")
    x, valid, ints, q = soft_stress(TRACK_CHANNELS, maxs, dev)
    hold_sync_soft(x.float(), valid, ints, q.float(), "float32 soft stress")
    seen = Counter()
    for name in SYNC_EDGE_CASES:
        x, valid, ints, q = sync_edge_case(name, dev)
        x, q = x.float(), q.float()
        if name == "view":
            cat = torch.zeros((x.shape[0], eb + x.shape[1] - 23),
                              dtype=torch.float32, device=dev)
            cat[:, eb - 23:] = x
            x = cat[:, eb - 23:]
        got, _ = hold_sync_soft(x, valid, ints, q, f"float32 {name}")
        hold_sync(got[7], got[8], valid, ints, q, f"float32 {name}")
        seen.update(got[4].cpu().numpy().ravel().tolist())
    log(f"[precision] (a) sync_scan[float32] both instantiations "
        f"bit-identical on the stress inputs ({int(on_thresh.sum())} locked "
        f"checks passed at float32's 0.7) and {', '.join(SYNC_EDGE_CASES)} "
        f"(events by code {[seen[k] for k in range(6)]}); the edges of "
        f"track_symbols[float32] held ({time.perf_counter() - t0:.1f} s)")
    return rows


def cpu_precision(job):
    """The host's twin run of one (b) job: rx_batch or StreamingDemodulator
    at float32 over a golden capture, with the card's CFO estimate pinned
    (run in a worker process)."""
    import torch
    from opv_tpu_torch.rx.pipeline import rx_batch
    from opv_tpu_torch.stream import StreamingDemodulator
    torch.set_num_threads(1)
    kind, name, opts = job
    if kind == "batch":
        out = rx_batch(capture(name), dtype="float32", device="cpu", **opts)
        return {k: out[k] for k in ("frames", "metrics", "t_idx", "sync_q",
                                    "n_symbols", "samples_used")}
    sd = StreamingDemodulator(device="cpu", dtype="float32", **opts)
    return sd.feed(capture(name)) + sd.flush()


def precision_goldens(dev, card):
    """(b) rx_batch(dtype="float32") and StreamingDemodulator(dtype=
    "float32") on the card over the nine golden checks (and raw3): every
    StreamingDemodulator run the reference's frames; rx_batch the
    reference's frames where the batch mode reads them (PRECISION_BATCH_
    GOLDENS); both equal to the same receiver on the host given the card's
    CFO estimate (the complex64 grid's argmax may round apart between
    devices): frames, metrics and symbol indices equal, sync quality within
    PRECISION_Q_TOL."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from opv_tpu_torch.rx.pipeline import rx_batch
    from opv_tpu_torch.stream import StreamingDemodulator
    t0 = time.perf_counter()
    batch, stream, jobs = [], [], []
    for name, gold, opts in TRACK_GOLDENS + (("raw3", "raw3.bin", {}),):
        out = rx_batch(capture(name), dtype="float32", device=dev, **opts)
        batch.append(out)
        pin = {"init_offset": float(out["est_offset"]), **opts}
        jobs.append(("batch", name, pin))
        if (name, gold) in PRECISION_BATCH_GOLDENS and \
                [bytes(f) for f in out["frames"]] != golden_frames(gold):
            raise AssertionError(f"[precision] (b) rx_batch float32 {name}: "
                                 f"{len(out['frames'])} frames, not {gold}")
    for name, gold, opts in TRACK_GOLDENS:
        sd = StreamingDemodulator(device=dev, dtype="float32", **opts)
        got = sd.feed(capture(name)) + sd.flush()
        stream.append(got)
        jobs.append(("stream", name, {**opts, "init_offset": sd.est_offset}))
        if [t[0] for t in got] != golden_frames(gold):
            raise AssertionError(f"[precision] (b) StreamingDemodulator "
                                 f"float32 {name} {opts}: {len(got)} frames, "
                                 f"not {gold}")
    card_s = time.perf_counter() - t0
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(8, mp_context=ctx) as pool:
        cpu = list(pool.map(cpu_precision, jobs))
    dq = 0.0
    for out, want, job in zip(batch, cpu, jobs):
        what = f"(b) rx_batch float32 {job[1]} card vs cpu"
        for k in ("frames", "metrics", "t_idx", "n_symbols", "samples_used"):
            if not np.array_equal(out[k], want[k]):
                raise AssertionError(f"[precision] {what}: {k} differs")
        dq = max(dq, float(np.abs(out["sync_q"] - want["sync_q"])
                           .max(initial=0)))
    for got, want, job in zip(stream, cpu[len(batch):], jobs[len(batch):]):
        dq = max(dq, same_tracking(got, want, f"(b) StreamingDemodulator "
                                   f"float32 {job[1]} card vs cpu",
                                   PRECISION_Q_TOL))
    if dq > PRECISION_Q_TOL:
        raise AssertionError(f"[precision] (b) sync quality card vs cpu "
                             f"differs by {dq:.3e}")
    n = sum(len(r) for r in stream)
    log(f"[precision] (b) float32 on the card: StreamingDemodulator the nine "
        f"golden checks byte for byte ({n} frames), rx_batch "
        f"{len(PRECISION_BATCH_GOLDENS)} goldens byte for byte "
        f"({sum(int(o['decoded']) for o in batch)} frames over "
        f"{len(batch)} captures); both equal to the host's float32 run at "
        f"the card's CFO (largest sync-quality difference {dq:.3e}); card "
        f"runs {card_s:.1f} s, est offsets "
        f"{[float(o['est_offset']) for o in batch]} ({card})")
    return dict(card_s=card_s, frames=n, max_q_diff=dq,
                est_offsets=[float(o["est_offset"]) for o in batch])


def divergent_feed():
    """tests/test_torch_tracking_multichannel.py's TestDivergentClocks feed:
    bert3 and bert3 resampled to a clock 300 ppm slower, three passes."""
    s = capture("bert3")
    ppm = 300e-6
    n_out = int(len(s) / (1 + ppm)) - 2
    t = np.arange(n_out) * (1 + ppm)
    i0 = t.astype(np.int64)
    f = t - i0
    slow = s[i0] * (1 - f) + s[i0 + 1] * f
    n = min(len(s), len(slow))
    return np.concatenate([np.stack([s[:n], slow[:n]])] * 3, axis=1)


def precision_divergent(dev, card):
    """(d) TestDivergentClocks' feed through MultiChannelTrackingDemodulator
    (2 channels) on the card at float64 and float32, against the same
    receiver on the host given the card's CFO estimates: no deadlock, no
    input lost (>= 8 frames a channel), tuples equal."""
    from opv_tpu_torch.stream import MultiChannelTrackingDemodulator
    x = divergent_feed()
    out = {}
    for dtype in ("float64", "float32"):
        t0 = time.perf_counter()
        mc = MultiChannelTrackingDemodulator(2, device=dev, dtype=dtype)
        got = mc.feed(x) + mc.flush()
        card_s = time.perf_counter() - t0
        cpu = MultiChannelTrackingDemodulator(
            2, device="cpu", dtype=dtype, init_offset=mc.est_offset)
        want = cpu.feed(x) + cpu.flush()
        per = [sum(1 for r in got if r[0] == c) for c in (0, 1)]
        if min(per) < 8:
            raise AssertionError(f"[precision] (d) {dtype}: frames a channel "
                                 f"{per}")
        dq = same_tracking([r[1:] + (r[0],) for r in got],
                           [r[1:] + (r[0],) for r in want],
                           f"(d) divergent clocks {dtype} card vs cpu",
                           PRECISION_Q_TOL)
        if [r[0] for r in got] != [r[0] for r in want]:
            raise AssertionError(f"[precision] (d) {dtype}: channel order "
                                 f"differs")
        out[dtype] = dict(frames=per, card_s=card_s, max_q_diff=dq,
                          est_offset=[float(v) for v in mc.est_offset])
        log(f"[precision] (d) divergent clocks (300 ppm, {x.shape[1]} "
            f"samples a channel) {dtype}: {per} frames, every tuple equal to "
            f"the host's at the card's CFO {out[dtype]['est_offset']} "
            f"(largest sync-quality difference {dq:.3e}; card {card_s:.1f} s "
            f"host clock) ({card})")
    return out


def precision_complex128(dev, card):
    """(e) the path of (e): smoke-64x20 as complex128 through rx_locked,
    rx_locked_steady and rx_fast on the card, in float64 as the JAX package
    computes complex128: every frame byte-exact, metric 0, at its delay
    (rx_fast: each whose payload fits, at its start or one sample late on
    the sync apex's plateau); peak memory.  Returns (stats, the steady
    block's soft-stage operands and nsym for precision_k3)."""
    import torch
    from opv_tpu_torch.rx import fast
    from opv_tpu_torch.rx.locked import (rx_locked, rx_locked_steady,
                                         soft_stage_operands)
    x, frames, delays = synthesize(dev)
    x = x.to(torch.complex128)
    c, n = x.shape
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    acq = rx_locked(x, n_frames=FRAMES)
    p0, foff, frac = acq["p0"], acq["freq_offset"], acq["frac"]
    steady = rx_locked_steady(x, p0, foff, FRAMES, frac=frac)
    out = fast.rx_fast(x, max_frames=DENSE_MAX_FRAMES)
    torch.cuda.synchronize(dev)
    host_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for what, o in (("rx_locked", acq), ("rx_locked_steady", steady)):
        fv = int(o["frame_valid"].sum())
        bad = int((o["metrics"] != 0).sum())
        same = bool((o["frames"] == frames[None]).all())
        if not (fv == c * FRAMES and bad == 0 and same
                and o["sync_q"].dtype == torch.float64):
            raise AssertionError(f"[precision] (e) {what} complex128: {fv}/"
                                 f"{c * FRAMES} valid, {bad} nonzero metrics, "
                                 f"byte-equal {same}, {o['sync_q'].dtype}")
    if p0.tolist() != list(delays):
        raise AssertionError(f"[precision] (e) p0 {p0.tolist()[:8]} != "
                             f"delays {delays[:8]}")
    r = dense_host(out)
    fits = [[d + k * SPF for k in range(FRAMES)
             if d + k * SPF + 960 + 2143 * 40 < n - 39] for d in delays]
    want_frames = [bytes(f) for f in frames.cpu().numpy()]
    exact = 0
    for ch, starts in enumerate(fits):
        fv = r["frame_valid"][ch]
        e, _ = check_dense_frames(
            list(zip((int(p) for p in r["starts"][ch][fv] - 960),
                     (int(m) for m in r["metrics"][ch][fv]),
                     (bytes(f) for f in r["frames"][ch][fv]))),
            [(p, want_frames[k]) for k, p in enumerate(starts)],
            f"precision (e) rx_fast complex128 channel {ch}")
        exact += e
    n_fit = sum(len(f) for f in fits)
    nsym = (n - 40) // 40
    ops = soft_stage_operands(x, p0 % 40, foff, nsym, None, frac)
    log(f"[precision] (e) smoke-{c}x{FRAMES} as complex128 ({n} samples a "
        f"channel, {c * n * 16 / 2**30:.2f} GiB): rx_locked and "
        f"rx_locked_steady {c * FRAMES}/{c * FRAMES} frames valid, metric 0, "
        f"byte-exact, p0 = delays, sync_q float64; rx_fast all {n_fit} "
        f"fitting frames byte-exact, {exact} at their exact start (the rest "
        f"one sample late on the apex plateau); {host_s:.1f} s host "
        f"clock for the three; peak memory {peak / 2**30:.2f} GiB ({card})")
    return dict(channels=c, frames=c * FRAMES, rx_fast_exact=exact,
                rx_fast_fit=n_fit, host_s=host_s, peak_bytes=peak), \
        (ops, nsym, x, (p0, foff, frac))


def precision_times(x, state, card):
    """(e) rx_locked_steady and rx_fast on smoke-64x20 as complex128 and as
    complex64 in turns (CUDA events, medians): what the float64 path
    costs."""
    import torch
    from opv_tpu_torch.rx import fast
    from opv_tpu_torch.rx.locked import rx_locked_steady
    p0, foff, frac = state
    inputs = {"complex64": x.to(torch.complex64), "complex128": x}
    res = {k: dict(steady_ms=[], rx_fast_ms=[]) for k in inputs}
    for name in ("complex64", "complex128", "complex128", "complex64"):
        xs = inputs[name]
        res[name]["steady_ms"].append(median_ms(
            lambda: rx_locked_steady(xs, p0, foff, FRAMES, frac=frac),
            STEADY_REPS))
        res[name]["rx_fast_ms"].append(median_ms(
            lambda: fast.rx_fast(xs, max_frames=DENSE_MAX_FRAMES), DENSE_REPS))
    log(f"[precision] (e) smoke-64x20 in turns (complex64, complex128, "
        f"complex128, complex64; medians of CUDA events): rx_locked_steady "
        f"{[round(v, 3) for v in res['complex128']['steady_ms']]} ms as "
        f"complex128 against {[round(v, 3) for v in res['complex64']['steady_ms']]}"
        f" as complex64 (its rows made from the samples in the call); rx_fast "
        f"{[round(v, 2) for v in res['complex128']['rx_fast_ms']]} against "
        f"{[round(v, 2) for v in res['complex64']['rx_fast_ms']]} ({card})")
    return res


def precision_k3(ops, nsym: int, card):
    """(e) the soft stage's float64 instantiation on the steady block's
    operands (64 channels of smoke-64x20 as complex128): held against its
    twin (soft and correlation within SOFT_F64_RTOL), its time, its bytes
    bound, the twin's time and torch.bmm's float64 time of the correlation
    (a yardstick the port never calls)."""
    import torch
    from opv_tpu_torch.ops import symbol_soft as ss
    err, scale_ref, raw_note = hold_soft(ops, nsym, "precision (e) K3 float64",
                                         SOFT_F64_RTOL)
    rows, kern = ops[0][:, : nsym + 1], ops[1]
    nbytes = ss.moved_bytes(*ops, nsym)
    bound_ms, bound_by = bound(nbytes, 2 * rows.numel() * 8,
                               PEAK_OPS_PER_S["f64"])
    ms = cuda_ms(lambda: ss.symbol_soft_cuda(*ops, nsym), KERNEL_REPS)
    plain = cuda_ms(lambda: ss.symbol_soft_reference(*ops, nsym), 3)
    library = cuda_ms(lambda: torch.bmm(rows, kern), KERNEL_REPS)
    cfg = ss.kernel_config(torch.float64)
    log(f"[precision] (e) symbol_soft[float64] rows {tuple(ops[0].shape)} "
        f"(a view of the complex128 samples), nsym {nsym}: max |kernel - "
        f"twin| {err:.4g} of max|soft| {scale_ref:.4g} (rel "
        f"{err / scale_ref:.3g}); {raw_note}; kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), roofline "
        f"{100 * bound_ms / ms:.1f}%; torch.bmm float64 of the correlation "
        f"{library:.4f} ms; twin {plain:.3f} ms; config {cfg} ({card})")
    return dict(ms=ms, plain_ms=plain, max_abs_err=err,
                max_rel_err=err / scale_ref, bound_ms=bound_ms,
                bound_by=bound_by, roofline=bound_ms / ms, library_ms=library,
                config=cfg)


def phase_precision(dev, card, int_ops_per_s: float, tracking: dict):
    """The float32 tracking receiver and the complex128 locked and dense
    receivers on the card (phase 13): the float32 kernels, the goldens,
    tracking-64 at float32 beside phase 11's float64 run, divergent clocks
    at both precisions, smoke-64x20 as complex128 and K3's float64
    instantiation."""
    import torch
    from opv_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    kernels = precision_kernels(dev, card, int_ops_per_s)
    routes = sync_routes(dev, card, torch.float32)
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    goldens = precision_goldens(dev, card)
    mc = tracking_64(dev, card, "float32")
    divergent = precision_divergent(dev, card)
    c128, (ops, nsym, x, state) = precision_complex128(dev, card)
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    k3 = precision_k3(ops, nsym, card)
    del ops
    c128["times"] = precision_times(x, state, card)
    del x
    need = ("track_symbols[float32]", "sync_scan[SoftSync,float32]",
            "viterbi_r4", "symbol_soft[float64]")
    if min(launches[k] for k in need) <= 0 \
            or launches["sync_scan[GivenSync,float32]"] \
            or routes["sync_scan[GivenSync,float32]"] <= 0:
        raise AssertionError(f"[precision] a kernel of the float32 path never "
                             f"launched, or GivenSync launched on it: "
                             f"{launches}; the GivenSync route: {routes}")
    f64 = tracking["tracking_64"]
    log(f"[precision] (c) tracking-64: float32 {mc['ms_per_chunk']:.2f} ms "
        f"per chunk ({mc['msps']:.1f} Msamples/s, {mc['x_real_time']:.2f}x "
        f"real time, peak {mc['peak_bytes'] / 2**30:.2f} GiB) against "
        f"float64's {f64['ms_per_chunk']:.2f} ms ({f64['msps']:.1f} "
        f"Msamples/s, {f64['x_real_time']:.2f}x, peak "
        f"{f64['peak_bytes'] / 2**30:.2f} GiB) in phase 11 of this run; "
        f"device ms per chunk float32 "
        f"{ {k: round(v, 3) for k, v in mc['device_ms_per_chunk'].items()} } "
        f"against float64 "
        f"{ {k: round(v, 3) for k, v in f64['device_ms_per_chunk'].items()} } "
        f"({card})")
    log(f"[precision] launches over (b)-(e) {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    kernels["symbol_soft[float64]"] = k3
    return dict(launches=launches, routes_launches=routes, kernels=kernels,
                goldens=goldens, tracking_64=mc, divergent=divergent,
                complex128=c128)


def mesh_of(dev, axes: dict):
    """A mesh naming the card once per entry (a mesh may repeat a device:
    each entry holds its own tensors)."""
    from opv_tpu_torch.parallel import make_mesh
    return make_mesh(axes, devices=[dev] * int(np.prod(list(axes.values()))))


def first_difference(got, want) -> str:
    """Where two tuple streams part, for an error message."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return (f"tuple {i}: {(g[0], g[2], g[3], g[4])} against "
                    f"{(w[0], w[2], w[3], w[4])}")
    return f"{len(got)} tuples against {len(want)}"


def mesh_stream(x, frames, delays, dev, card):
    """(a) stream-64's feed through the engine on a ('ch'=MESH_CH) mesh
    naming the card MESH_CH times and unsharded, synchronous and
    pipelined, float32 rows and int8 + AGC: the tuples equal, the
    transmitted frames once each (float32); launches per block; then ms
    per block on bench.py's cyclic feed, sharded against unsharded.
    Returns (record, the kernel operands kept for the holds)."""
    import torch
    from opv_tpu_torch.ops import registry
    feed, want = stream_feed(x, frames, delays, dev)
    mesh = mesh_of(dev, {"ch": MESH_CH})
    rec, kept = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    for dtype, agc in (("float32", False), ("int8", True)):
        for pipeline in (False, True):
            arm = f"{dtype}{' + AGC' if agc else ''}, " + (
                "pipelined" if pipeline else "synchronous")
            per_block = {}
            for name, extra in (("unsharded", {}),
                                ("sharded", {"mesh": mesh})):
                before = registry.launch_counts()
                out, sd, calls, held = drive_stream(
                    feed, dev, dtype, spy=bool(extra) and not pipeline,
                    agc=agc, pipeline=pipeline, **extra)
                after = registry.launch_counts()
                blocks = len(sd.block_stats)
                per_block[name] = {k: (after[k] - before[k]) / blocks
                                   for k in ("viterbi_r4",
                                             f"symbol_soft[{dtype}]")}
                if extra:
                    got, shards = out, [tuple(p.shape) for p in sd._buf.parts]
                    if held:
                        kept[arm] = held
                else:
                    ref = out
            if got != ref:
                raise AssertionError(f"[mesh] (a) {arm}: the sharded engine's "
                                     f"tuples differ: "
                                     f"{first_difference(got, ref)}")
            if dtype == "float32":
                check_stream(got, want, f"mesh {arm}")
            if shards != [(x.shape[0] // MESH_CH, sd.window // 40, 80)] \
                    * MESH_CH:
                raise AssertionError(f"[mesh] (a) window shards {shards}")
            rec[arm] = dict(tuples=len(got), launches_per_block=per_block)
            log(f"[mesh] (a) stream-64 {arm} on a ('ch'={MESH_CH}) mesh of "
                f"the card: {len(got)} tuples equal to the unsharded "
                f"engine's; launches per block {per_block}")
    peak = torch.cuda.max_memory_allocated(dev)
    thr = {}
    for pipeline in (False, True):
        for name, extra in (("unsharded", {}), ("sharded", {"mesh": mesh}),
                            ("sharded again", {"mesh": mesh}),
                            ("unsharded again", {})):
            msps, ms, blocks = stream_throughput(x, dev, "float32",
                                                 pipeline=pipeline, **extra)
            thr[f"{'pipelined' if pipeline else 'synchronous'} {name}"] = \
                dict(msamples_s=msps, ms_per_block=ms,
                     device_wait_ms=statistics.mean(
                         b["device_wait_ms"] for b in blocks),
                     lifecycle_ms=statistics.mean(b["host_ms"]
                                                  for b in blocks))
    log(f"[mesh] (a) ms per steady block of bench.py's cyclic feed, float32, "
        f"in turns: "
        + "; ".join(f"{k} {v['ms_per_block']:.3f} (wait "
                    f"{v['device_wait_ms']:.3f}, lifecycle "
                    f"{v['lifecycle_ms']:.3f})" for k, v in thr.items())
        + f"; peak memory of the drives {peak / 2**30:.2f} GiB ({card})")
    return dict(runs=rec, throughput=thr, peak_bytes=peak), kept


def mesh_wideband(dev, card):
    """(b) wideband-64 periodic (phase 10 (g)'s feed) through
    WidebandReceiver(WB_K, block_frames=WB_BF) unsharded and on a
    ('ch'=MESH_CH) mesh of the card: every tuple of a window, the warm-up
    and the timed quanta equal; ms per quantum."""
    import torch
    from opv_tpu_torch.stream import WidebandReceiver
    xp, period = periodic_wideband(dev)
    res, outs = {}, {}
    for name, mesh in (("unsharded", None),
                       ("sharded", mesh_of(dev, {"ch": MESH_CH}))):
        rx = WidebandReceiver(WB_K, block_frames=WB_BF, device=dev, mesh=mesh)
        q = rx.quantum
        src = torch.cat([xp, xp[: rx.window + q]])
        out = rx.feed(src[: rx.window])
        pos = rx.window
        for _ in range(WB_WARM_QUANTA):
            out += rx.feed(src[pos % period: pos % period + q])
            pos += q
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(WB_TIMED_QUANTA):
            out += rx.feed(src[pos % period: pos % period + q])
            pos += q
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / WB_TIMED_QUANTA
        outs[name] = out
        res[name] = dict(ms_per_quantum=ms, tuples=len(out),
                         x_real_time=q / ms / 1e3 / (WB_K * REAL_TIME_MSPS))
    if outs["sharded"] != outs["unsharded"]:
        diff = first_difference(outs["sharded"], outs["unsharded"])
        raise AssertionError(f"[mesh] (b) the sharded wideband receiver's "
                             f"tuples differ: {diff}")
    if not outs["sharded"]:
        raise AssertionError("[mesh] (b) no frame decoded")
    log(f"[mesh] (b) wideband-64 periodic, {len(outs['sharded'])} tuples "
        f"equal sharded ('ch'={MESH_CH}) and unsharded; ms per quantum "
        f"{res['unsharded']['ms_per_quantum']:.3f} unsharded "
        f"({res['unsharded']['x_real_time']:.2f}x real time), "
        f"{res['sharded']['ms_per_quantum']:.3f} sharded "
        f"({res['sharded']['x_real_time']:.2f}x) ({card})")
    return res


def mesh_rx_fast(x, frames, delays, dev, card):
    """(c) smoke-64x20's signal: rx_fast_sharded ('ch'=MESH_CH) against
    rx_fast (frames equal, the count that of the valid frames); channel 0
    as one long channel through rx_time_sharded ('time'=MESH_TIME): its
    frames once each, starts within one sample of i x 86,720."""
    import torch
    from opv_tpu_torch.parallel import rx_fast_sharded, rx_time_sharded
    from opv_tpu_torch.rx.fast import rx_fast
    want = rx_fast(x, max_frames=DENSE_MAX_FRAMES)
    got, n = rx_fast_sharded(mesh_of(dev, {"ch": MESH_CH}), x,
                             max_frames_per_shard=DENSE_MAX_FRAMES)
    if not torch.equal(got, want["frames"]) \
            or int(n) != int(want["frame_valid"].sum()):
        raise AssertionError(f"[mesh] (c) rx_fast_sharded: frames equal "
                             f"{torch.equal(got, want['frames'])}, n {int(n)} "
                             f"against {int(want['frame_valid'].sum())}")
    t = x.shape[1] // MESH_TIME * MESH_TIME
    one = x[:1, :t]
    tm = mesh_of(dev, {"time": MESH_TIME})
    out = rx_time_sharded(tm, one, max_frames_per_shard=8)
    owned = out["owned"][0]
    starts = out["starts"][0][owned].cpu().numpy()
    fr = out["frames"][0][owned]
    if int(out["n"]) != FRAMES or not torch.equal(fr, frames) \
            or np.abs(starts - delays[0] - np.arange(FRAMES) * SPF).max() > 1:
        raise AssertionError(f"[mesh] (c) rx_time_sharded: n {int(out['n'])}, "
                             f"starts {starts.tolist()}")
    ms = dict(rx_fast=median_ms(lambda: rx_fast(
        x, max_frames=DENSE_MAX_FRAMES), MESH_REPS),
        rx_fast_sharded=median_ms(lambda: rx_fast_sharded(
            mesh_of(dev, {"ch": MESH_CH}), x,
            max_frames_per_shard=DENSE_MAX_FRAMES), MESH_REPS))
    log(f"[mesh] (c) rx_fast_sharded ('ch'={MESH_CH}) frames equal rx_fast's, "
        f"n {int(n)}; rx_time_sharded ('time'={MESH_TIME}) {FRAMES} frames "
        f"once, starts within 1 of i x {SPF}; ms per call (median of "
        f"{MESH_REPS}) rx_fast {ms['rx_fast']:.2f}, rx_fast_sharded "
        f"{ms['rx_fast_sharded']:.2f} ({card})")
    return dict(n=int(n), ms=ms)


def mesh_grid_stream(x, frames, delays, dev, card):
    """(d) ShardedStreamDemodulator on a (ch, time) = MESH_GRID mesh of the
    card over smoke-64x20's 64 channels, fed in chunks that straddle the
    windows: every frame once, byte-exact, at its position +-1; a
    checkpoint written mid-stream resumes to the same tuples."""
    import torch
    from opv_tpu_torch.stream import (ShardedStreamDemodulator, load_state,
                                      save_state)
    mesh = mesh_of(dev, {"ch": MESH_GRID[0], "time": MESH_GRID[1]})
    chunk = MESH_GRID_CHUNK

    def run(sd, lo, hi):
        out = []
        for off in range(lo, hi, chunk):
            out += sd.feed(x[:, off:min(off + chunk, hi)])
        return out

    n = x.shape[1]
    cut = n // 2
    t0 = time.perf_counter()
    sd = ShardedStreamDemodulator(mesh, x.shape[0], max_frames_per_shard=4)
    head = run(sd, 0, cut)
    ck = pathlib.Path("build/chip_smoke")
    ck.mkdir(parents=True, exist_ok=True)
    save_state(str(ck / "mesh_grid"), sd.state_tree())
    tail = run(sd, cut, n) + sd.flush()
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    out = head + tail
    for c in range(x.shape[0]):
        mine = [r for r in out if r[0] == c]
        pos = np.array([r[4] for r in mine])
        if [r[1] for r in mine] != [bytes(f) for f in frames.cpu().numpy()] \
                or np.abs(pos - delays[c] - np.arange(FRAMES) * SPF).max() > 1:
            raise AssertionError(f"[mesh] (d) channel {c}: {len(mine)} "
                                 f"frames, positions {pos.tolist()[:4]}")
    sd2 = ShardedStreamDemodulator(mesh, x.shape[0], max_frames_per_shard=4)
    sd2.load_state_tree(load_state(str(ck / "mesh_grid"), sd2.state_tree()))
    resumed = run(sd2, cut, n) + sd2.flush()
    if resumed != tail:
        raise AssertionError(f"[mesh] (d) resumed: "
                             f"{first_difference(resumed, tail)}")
    log(f"[mesh] (d) grid stream on a {MESH_GRID[0]} x {MESH_GRID[1]} mesh of "
        f"the card, {x.shape[0]} ch, window {sd.window}, {chunk}-sample "
        f"feeds: {len(out)} frames once each, byte-exact, at their "
        f"positions; resumed from the mid-stream checkpoint to the same "
        f"{len(tail)} tuples; {secs:.2f} s host clock for the stream "
        f"({card})")
    return dict(tuples=len(out), window=sd.window, seconds=secs)


def mesh_processes(card):
    """(e) chip_smoke.py as two worker processes on the card (gloo): each
    checks its runs against its own single-process run; both ranks must
    report the same tuples.  A worker's failure or timeout fails."""
    port = free_port_tcp()
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--mesh-worker", str(rank), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(repo_root()))
        for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MESH_WORKER_TIMEOUT_S)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"[mesh] (e) worker rc {p.returncode}:\n"
                                     f"{out[-3000:]}\n{err[-3000:]}")
            results.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    a, b = results
    if a["digest"] != b["digest"] or not (a["ok"] and b["ok"]):
        raise AssertionError(f"[mesh] (e) ranks disagree: {a} {b}")
    log(f"[mesh] (e) two processes on the card (gloo): (ch=2, time=2) grid "
        f"decode and grid stream equal to the single-process runs, the "
        f"locked engine (8 ch of stream-64, 'ch' across the processes) "
        f"{a['locked_tuples']} tuples equal to the single-process engine's, "
        f"both ranks the same tuples; per rank peak memory "
        f"{a['peak_bytes'] / 2**30:.2f} / {b['peak_bytes'] / 2**30:.2f} GiB, "
        f"{a['seconds']:.1f} / {b['seconds']:.1f} s ({card})")
    return dict(ranks=results)


def free_port_tcp() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_worker(rank: int, port: int, device: str = "cuda") -> int:
    """One rank of (e): the (ch=2, time=2) grid decode on global_mesh, the
    grid stream on a mesh whose 'time' axis spans the processes (halos and
    slides over gloo) and the locked engine with 'ch' across the
    processes, each against the same run on a single-process mesh.
    Prints one JSON line."""
    import hashlib
    import torch
    from opv_tpu_torch.parallel import (global_mesh, initialize_multihost,
                                        rx_grid_sharded)
    from opv_tpu_torch.parallel.mesh import Mesh
    from opv_tpu_torch.stream import ShardedStreamDemodulator
    t0 = time.perf_counter()
    dev = torch.device(device)
    initialize_multihost(f"127.0.0.1:{port}", num_processes=2,
                         process_id=rank)
    # two channels, their own frames, 3 frames a time shard
    sigs = [transmission(6, dev, start=10 * c)[0] for c in range(2)]
    t = 2 * 3 * SPF
    x = torch.zeros((2, t), dtype=torch.complex64, device=dev)
    for c, s in enumerate(sigs):
        x[c, : min(t, len(s))] = s[:t]
    gmesh = global_mesh(ch=2, time=2, devices=[dev] * 2)
    got = rx_grid_sharded(gmesh, x, max_frames_per_shard=4)
    single = rx_grid_sharded(mesh_of(dev, {"ch": 2, "time": 2}), x,
                             max_frames_per_shard=4)
    for k in single:
        if not torch.equal(got[k].cpu(), single[k].cpu()):
            raise AssertionError(f"rank {rank}: grid decode {k} differs")
    cross = Mesh(np.array([[dev, dev], [dev, dev]], dtype=object),
                 ("ch", "time"), ranks=[[0, 1], [0, 1]])

    def stream(m):
        sd = ShardedStreamDemodulator(m, 2, max_frames_per_shard=4)
        out = []
        for off in range(0, t, 70_001):
            out += sd.feed(x[:, off:off + 70_001])
        return out + sd.flush()

    grid_tuples = stream(cross)
    if grid_tuples != stream(mesh_of(dev, {"ch": 2, "time": 2})):
        raise AssertionError(f"rank {rank}: grid stream tuples differ")
    # the locked engine: channels 52-59 of stream-64 (4 clean, 4 gap-burst)
    xs, frames, delays = synthesize(dev)
    feed, _ = stream_feed(xs, frames, delays, dev)
    feed = feed[STREAM_CLEAN - 4: STREAM_CLEAN + 4].contiguous()
    del xs
    lmesh = global_mesh(ch=8, time=1, devices=[dev] * 4)
    torch.cuda.reset_peak_memory_stats(dev)
    locked, sd, _, _ = drive_stream(feed, dev, "float32", spy=False,
                                    mesh=lmesh)
    if sum(p.shape[0] for p in sd._buf.parts) != 4:
        raise AssertionError(f"rank {rank}: {len(sd._buf.parts)} local shards")
    ref, _, _, _ = drive_stream(feed, dev, "float32", spy=False)
    if locked != ref:
        raise AssertionError(f"rank {rank}: locked engine: "
                             f"{first_difference(locked, ref)}")
    digest = hashlib.sha256(repr((grid_tuples, locked)).encode()).hexdigest()
    import torch.distributed as dist
    dist.destroy_process_group()
    print(json.dumps(dict(rank=rank, ok=True, digest=digest,
                          grid_n=int(got["n"]), locked_tuples=len(locked),
                          peak_bytes=torch.cuda.max_memory_allocated(dev),
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


def phase_mesh(dev, card):
    """Phase 14: the multi-device modes on the card, a mesh naming it
    several times: (a) the sharded engine, (b) the sharded wideband
    receiver, (c) the sharded rx_fast family, (d) the grid stream, (e) two
    processes over gloo, (f) dryrun_multichip."""
    import torch
    from opv_tpu_torch.entry import dryrun_multichip
    from opv_tpu_torch.ops import registry
    t_phase = time.perf_counter()
    x, frames, delays = synthesize(dev)
    registry.set_viterbi_radix(4)
    registry.reset_launch_counts()
    a, kept = mesh_stream(x, frames, delays, dev, card)
    b = mesh_wideband(dev, card)
    c = mesh_rx_fast(x, frames, delays, dev, card)
    d = mesh_grid_stream(x, frames, delays, dev, card)
    del x
    t0 = time.perf_counter()
    dryrun_multichip(MESH_CH)
    torch.cuda.synchronize(dev)
    f_secs = time.perf_counter() - t0
    log(f"[mesh] (f) dryrun_multichip({MESH_CH}) on the card: {f_secs:.1f} s "
        f"({card})")
    launches = registry.launch_counts()
    need = ("viterbi_r4", "symbol_soft[float32]", "symbol_soft[int8]")
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"[mesh] a kernel of the sharded paths never "
                             f"launched: {launches}")
    # each kept kernel call (shard 0's first of each program) against its
    # twin, after the count
    held = []
    for arm, ops in kept.items():
        held += hold_stream_kernels(ops, f"mesh {arm}")
    for h in held:
        rel = (f" (rel {h['max_rel_err']:.3g})" if "max_rel_err" in h
               else ", bit-identical")
        log(f"[mesh] {h['run']} {h['program']} block: {h['kernel']} at a "
            f"shard's operands {h['shape']} against its twin, max |kernel - "
            f"twin| {h['max_abs_err']:.4g}{rel}")
    e = mesh_processes(card)
    log(f"[mesh] launches over (a)-(d), (f) {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, a=a, b=b, c=c, d=d, e=e,
                f_seconds=f_secs, held=held)


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
    del x
    wideband = phase_wideband(dev, card)
    tracking = phase_tracking(dev, card, int_ops_per_s, cli["processes"])
    dense = phase_dense(dev, card)
    precision = phase_precision(dev, card, int_ops_per_s, tracking)
    mesh = phase_mesh(dev, card)
    phases = (("stream", stream), ("modes", modes), ("cli", cli),
              ("wideband", wideband), ("tracking", tracking),
              ("dense", dense), ("precision", precision), ("mesh", mesh))
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
        k["launches_wideband"] = wideband["launches"][k["name"]]
        k["launches_tracking"] = tracking["launches"][k["name"]]
        k["launches_dense"] = dense["launches"][k["name"]]
        k["launches_precision"] = precision["launches"][k["name"]]
        k["launches_mesh"] = mesh["launches"][k["name"]]
    # one kernel template, counted per row type where it launches
    for name, rows in (("f32", "float32"), ("int8", "int8")):
        key = f"symbol_soft[{rows}]"
        kernels.append(dict(
            name=key, route="cuda", source="opv_tpu_torch/csrc/symbol_soft.cu",
            replaces="opv_tpu/ops/pallas/correlate.py:37",
            launches=launches[key], launches_stream=stream["launches"][key],
            launches_modes=modes["launches"][key],
            launches_cli=cli["launches"][key],
            launches_wideband=wideband["launches"][key],
            launches_tracking=tracking["launches"][key],
            launches_dense=dense["launches"][key],
            launches_precision=precision["launches"][key],
            launches_mesh=mesh["launches"][key], **soft[name]))
    kernels.append(dict(
        name="phase_track", route="cuda",
        source="opv_tpu_torch/csrc/phase_track.cu",
        replaces="opv_tpu/tx/modulator.py:188",
        launches=cli["mod_launches"]["phase_track"],
        launches_stream=stream["launches"]["phase_track"],
        launches_modes=modes["launches"]["phase_track"],
        launches_cli=cli["launches"]["phase_track"],
        launches_wideband=wideband["launches"]["phase_track"],
        launches_tracking=tracking["launches"]["phase_track"],
        launches_dense=dense["launches"]["phase_track"],
        launches_precision=precision["launches"]["phase_track"],
        launches_mesh=mesh["launches"]["phase_track"],
        **cli["phase_track"]))
    # the tracking receiver's kernels: ms and bound at C = 64 (one chunk of
    # the golden mix); launches: the tracking phase's (b)-(d), GivenSync's
    # from its own route (sync_routes)
    for name, replaces in (("track_symbols", "opv_tpu/rx/demod.py:195"),
                           ("sync_scan[GivenSync]", "opv_tpu/rx/sync.py:166"),
                           ("sync_scan[SoftSync]", "opv_tpu/rx/sync.py:166")):
        row = dict(tracking["kernels"][TRACK_CHANNELS][name])
        row.pop("symbols", None)
        given = name == "sync_scan[GivenSync]"
        kernels.append(dict(
            name=name, route="cuda",
            source=f"opv_tpu_torch/csrc/{name.split('[')[0]}.cu",
            replaces=replaces,
            launches=(tracking["routes_launches"] if given
                      else tracking["launches"])[name],
            **{f"launches_{ph}": res["launches"][name]
               for ph, res in phases},
            **row))
    # their float32 instantiations: ms and bound at C = 64 (phase 13 (a),
    # beside the float64 kernel timed in turns); launches: phase 13's
    # (b)-(d), GivenSync's from its own float32 route
    for name, replaces in (("track_symbols[float32]", "opv_tpu/rx/demod.py:195"),
                           ("sync_scan[GivenSync,float32]",
                            "opv_tpu/rx/sync.py:166"),
                           ("sync_scan[SoftSync,float32]",
                            "opv_tpu/rx/sync.py:166")):
        row = dict(precision["kernels"][TRACK_CHANNELS][name])
        row.pop("symbols", None)
        given = name.startswith("sync_scan[GivenSync")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"opv_tpu_torch/csrc/{name.split('[')[0]}.cu",
            replaces=replaces,
            launches=(precision["routes_launches"] if given
                      else precision["launches"])[name],
            **{f"launches_{ph}": res["launches"][name]
               for ph, res in phases},
            **row))
    key = "symbol_soft[float64]"
    kernels.append(dict(
        name=key, route="cuda", source="opv_tpu_torch/csrc/symbol_soft.cu",
        replaces="opv_tpu/ops/pallas/correlate.py:37",
        launches=precision["launches"][key],
        **{f"launches_{ph}": res["launches"][key] for ph, res in phases},
        **precision["kernels"][key]))
    print(json.dumps({"kernels": kernels, "steady_ms": steady,
                      "stream": stream, "modes": modes, "cli": cli,
                      "wideband": wideband, "tracking": tracking,
                      "dense": dense, "precision": precision,
                      "mesh": mesh, "peak_bytes": peak}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
