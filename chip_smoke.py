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
  7. the kernels JSON line, the card line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

There is no CPU fallback: without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

CHANNELS = 64
FRAMES = 20
#: soft stage: |kernel - twin| <= SOFT_RTOL * max|twin| (float32 sums of 80
#: products taken in another order, and fused multiply-adds in the combine)
SOFT_RTOL = 1e-5
KERNEL_REPS = 20
#: published H100 SXM peaks (NVIDIA's H100 datasheet): HBM bytes/s, and
#: operations/s for float32 outside the tensor cores and for int8
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}
#: int32 operations of the Viterbi per trellis state per step: two adds
#: (each predecessor's path metric plus its branch metric), a compare of
#: the two candidates and a select of the survivor
VITERBI_OPS_PER_STATE_STEP = 4
#: ... and per step, shared by all 64 states: the four distinct branch
#: metrics of a rate-1/2 code (one per pair of expected output bits)
VITERBI_OPS_PER_STEP = 4
STEADY_REPS = 7
THROUGHPUT_BLOCKS = 20


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
            bits_k, met_k = kern(soft)
            bits_t, met_t = vit.viterbi_reference(soft, radix)
            err = max(err, int((bits_k != bits_t).sum(1).max()),
                      int((met_k - met_t).abs().max()))
            if not (torch.equal(bits_k, bits_t) and torch.equal(met_k, met_t)):
                bad = (bits_k != bits_t).any(1) | (met_k != met_t)
                raise AssertionError(
                    f"viterbi radix {radix} B={soft.shape[0]}: kernel != twin "
                    f"on rows {torch.nonzero(bad)[:8, 0].tolist()}")
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


def synthesize(dev):
    """(C, N) complex64 on the card: the 20-frame BERT stream through the
    port's TX, channel c delayed by (c % 40) + 487 c samples."""
    import torch
    from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
    from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                            modulate_frames, tx_flush_zeros)
    frames = torch.from_numpy(build_bert_frame("W5NYV",
                                               frame_num=np.arange(FRAMES)))
    iq, _ = modulate_frames(encode_frame(frames.to(dev)))
    s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros(device=dev)]))
    delays = [(c % 40) + 487 * c for c in range(CHANNELS)]
    n = -(-(len(s) + max(delays)) // 40) * 40
    x = torch.zeros((CHANNELS, n), dtype=torch.complex64, device=dev)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s
    return x, frames.to(dev), delays


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
        got = ss.symbol_soft_cuda(*ops, nsym)
        want = ss.symbol_soft_reference(*ops, nsym)
        raw_k = ss.symbol_soft_cuda(*ops, nsym, raw=True)
        raw_t = ss.symbol_soft_reference(*ops, nsym, raw=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale_ref = float(want.abs().max())
        if not err <= SOFT_RTOL * scale_ref:
            raise AssertionError(f"soft {name}: max |kernel - twin| {err:.4g} "
                                 f"> {SOFT_RTOL} x {scale_ref:.4g}")
        if dt == torch.int8:
            if not torch.equal(raw_k, raw_t):
                raise AssertionError("soft int8: s32 dot differs from the "
                                     "twin's int32 contraction")
            raw_note = "s32 dot exact"
        else:
            raw_err = float((raw_k - raw_t).abs().max())
            raw_ref = float(raw_t.abs().max())
            if not raw_err <= SOFT_RTOL * raw_ref:
                raise AssertionError(f"soft f32 correlation: {raw_err:.4g} > "
                                     f"{SOFT_RTOL} x {raw_ref:.4g}")
            raw_note = f"correlation max err {raw_err:.4g} of {raw_ref:.4g}"
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
    if min(launches.values()) <= 0:
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


def phase_profile(state, card, out_dir="build/chip_smoke"):
    """Device time by op over three steady blocks per buffer type."""
    import pathlib
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
    kernels = [
        dict(name="viterbi_r4", route="cuda", source="opv_tpu_torch/csrc/viterbi.cu",
             replaces="opv_tpu/ops/pallas/viterbi.py:256",
             launches=launches["viterbi_r4"], **vit[4]),
        dict(name="viterbi_r2", route="cuda", source="opv_tpu_torch/csrc/viterbi.cu",
             replaces="opv_tpu/ops/pallas/viterbi.py:145",
             launches=launches["viterbi_r2"], **vit[2]),
    ]
    # one kernel template, counted per row type where it launches
    for name, rows in (("f32", "float32"), ("int8", "int8")):
        key = f"symbol_soft[{rows}]"
        kernels.append(dict(
            name=key, route="cuda", source="opv_tpu_torch/csrc/symbol_soft.cu",
            replaces="opv_tpu/ops/pallas/correlate.py:37",
            launches=launches[key], **soft[name]))
    print(json.dumps({"kernels": kernels, "steady_ms": steady,
                      "peak_bytes": peak}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
