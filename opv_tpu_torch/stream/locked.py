"""Locked-grid streaming engine, synchronous: the production multichannel
receiver of the port.

Wraps rx_locked_reacquire / rx_locked_steady / rx_locked_retime
(rx/locked.py) in a stateful block-streaming class with the reference's
sync lifecycle (src/opv-demod.cpp:615-736):

  * HUNTING: unlocked channels are re-acquired every block (dense sync
    hunt at the carried CFO, CFO estimate at the found grid).  A channel
    locks when a frame's sync meets the hunting thresholds (norm >= 0.85
    and raw >= 5000) and a second sync follows one frame later; a lone
    unverified frame is emitted without taking the lock (burst salvage).
  * LOCKED: all-locked blocks run the steady body alone (no acquisition);
    each frame's sync quality q >= 0.70 keeps the lock.
  * FLYWHEEL: up to sync_miss_limit (5) consecutive sub-threshold syncs
    still emit frames on the predicted grid; one more miss drops the
    channel to HUNTING, and the same window is re-hunted at once.

Locked channels whose sync quality or Viterbi metric show an early timing
slip get a folded timing refresh (rx_locked_retime) at the next block,
blended through a per-channel fold accumulator, a trust region and a
two-block confirmation of drift-sized moves (see _run_block).

Blocks advance by an exact multiple of 86,720 samples, so a locked
channel's sync position p0 within the window is invariant across blocks.
The buffer holds (C, window/40, 80) window rows on the engine's device
(row s = samples [40s, 40s+40) as 80 interleaved I/Q values), which is
the steady body's soft-stage operand as it is.  Complex samples are built
from the rows only on the re-acquire and retime paths.

The device programs of the JAX package's engine (opv_tpu/stream/locked.py)
are plain torch functions here, on the engine's device; the host
lifecycle is the same numpy code.  This module ports the synchronous
engine: pipeline, eager, hunt_stride > 1 and int8 AGC (ROADMAP queue 1,
item 7c), mesh (item 12) and the external fused ingest of the wideband
receiver (item 9) are not ported, and asking for them raises
NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.locked import (INT8_SCALE, fold_est_np,
                                     rx_locked_reacquire, rx_locked_retime,
                                     rx_locked_steady)
from opv_tpu_torch.stream.state import to_host

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


class LockedStreamDemodulator:
    """Feed (C, n) complex sample blocks; yields (channel, frame_bytes,
    metric, sync_quality, abs_sample_pos) tuples, where abs_sample_pos is
    the absolute stream index of the frame's sync-word start."""

    #: timing refresh triggers: sync quality below REFRESH_Q, or the Viterbi
    #: metric REFRESH_METRIC_RISE above the channel's EMA while above
    #: REFRESH_METRIC_MIN (opv_tpu/stream/locked.py:74-101 for the why)
    REFRESH_Q = 0.90
    REFRESH_METRIC_RISE = 400
    REFRESH_METRIC_MIN = 400
    _EMA_ALPHA = 0.1
    #: a retime estimate within this many samples of the carried grid is
    #: noise: its fold is accumulated and the grid re-estimated from the
    #: accumulated fold; a larger jump is adopted only when two consecutive
    #: retimes propose it the same way and a deep accumulator agrees
    _TIMING_TRUST = 2.0
    #: fold accumulator decay once it is deep (~33-window memory)
    _FOLD_DECAY = 0.97
    #: accumulated weight above which the deep fold can veto a big jump
    _FOLD_DEEP = 6.0
    #: warm-up: a locked channel retimes every block until its accumulator
    #: holds ~this many fold intervals ...
    _FOLD_WARM_FOLDS = 100.0
    #: ... if its Viterbi metric EMA says it is near the FEC waterfall
    _WARM_METRIC_MIN = 100.0

    def __init__(self, channels: int, block_frames: int = 4,
                 dtype: str = "auto", pipeline: bool = False,
                 agc: bool = True, mesh=None,
                 single_frame_burst: bool = True, timing: bool = False,
                 eager: bool = False, hunt_stride: int = 1,
                 device="cuda"):
        """dtype: the window-row buffer's element type, "float32",
        "bfloat16" or "int8" (samples / INT8_SCALE, rounded half to even
        and clipped to +-127: the wire's full scale maps to +-127).  "auto"
        means float32 in the port until the buffer dtype for CUDA is
        decided (ROADMAP queue 2).

        agc: int8 buffers only.  The port has no AGC yet (item 7c), so an
        int8 engine needs agc=False and quantizes at the fixed INT8_SCALE
        step (or the per-channel step of a loaded checkpoint).

        device: where the buffer lives and every program runs; "cuda"
        runs the hand-written kernels (and raises without a card), "cpu"
        their plain twins.  Host feeds are copied there.

        single_frame_burst: emit an isolated single-frame burst's frame
        without locking (reference semantics, opv-demod.cpp:657-680, minus
        the false-lock flywheel cost); off, such bursts are dropped.

        timing: record per block the program tag, the time spent waiting
        on the device result (device_wait_ms: one synchronize and the copy
        of every result to the host) and the host lifecycle time (host_ms)
        in block_stats; stats() aggregates them.

        pipeline, eager, hunt_stride > 1, int8 with agc=True and mesh are
        not ported and raise NotImplementedError."""
        if pipeline:
            raise NotImplementedError(
                "pipeline=True is not ported yet (ROADMAP queue 1, item 7c)")
        if eager:
            raise NotImplementedError(
                "eager=True is not ported yet (ROADMAP queue 1, item 7c)")
        if hunt_stride != 1:
            raise NotImplementedError(
                "hunt_stride > 1 is not ported yet (ROADMAP queue 1, "
                "item 7c)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (channel-sharded engine) is not ported yet (ROADMAP "
                "queue 1, item 12)")
        if dtype == "auto":
            dtype = "float32"
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)} or "
                             f"'auto', got {dtype!r}")
        self.dtype = _DTYPES[dtype]
        self._int8 = self.dtype == torch.int8
        if self._int8 and agc:
            raise NotImplementedError(
                "int8 AGC is not ported yet (ROADMAP queue 1, item 7c); "
                "pass agc=False for the fixed INT8_SCALE step")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LockedStreamDemodulator(device='cuda') needs a CUDA device; "
                "pass device='cpu' to run the plain twins on the host")
        # sub-row pend carry stays at WIRE scale (int8's buffer domain is
        # quantized; re-quantizing a quantized tail would double-divide)
        self._wire = torch.float32 if self._int8 else self.dtype

        self.channels = channels
        self.block_frames = block_frames
        spf = CONFIG.samples_per_frame
        self.spf = spf
        self.advance = block_frames * spf
        # window: p0 < 86,720 plus block_frames full frames plus the slack
        # (sync window + correlator tail + margin) that the hunt's
        # next-frame verification needs for every sync this block owns
        self.window = (block_frames + 1) * spf + 1040
        self.sps = CONFIG.samples_per_symbol     # row width in samples
        assert self.window % self.sps == 0 and self.advance % self.sps == 0

        self._buf = self._zeros()
        self._count = 0                 # valid samples in buffer
        self._pend = None               # (C, <40, 2) sub-row feed tail
        self._abs_base = 0              # absolute index of buffer sample 0

        # per-channel lock state (host side: tiny, drives which program runs)
        self._state_cache = {}           # content-keyed device copies
        self.p0 = np.zeros(channels, np.int32)
        self.frac = np.zeros(channels, np.float32)   # sub-sample timing
        self.freq_offset = np.zeros(channels, np.float32)
        self.locked = np.zeros(channels, bool)
        self.miss = np.zeros(channels, np.int32)    # consecutive sync misses
        self.refresh = np.zeros(channels, bool)     # retime next block
        self._want_refresh = np.zeros(channels, bool)
        self.metric_ema = np.full(channels, np.nan)  # per-channel baseline
        self.refreshes = 0               # completed drift refreshes (p0 moved)
        # cross-block folded-timing accumulator: bin b of row c maps to
        # sample offset p0[c] - 20 + b of the current window
        self._fold_acc = np.zeros((channels, 2 * (self.sps // 2) + 3),
                                  np.float64)
        self._fold_ok = np.zeros(channels, bool)
        self._fold_w = np.zeros(channels)   # decayed window count (depth)
        # sign of the last unconfirmed drift-sized retime proposal (0 = none)
        self._big_dir = np.zeros(channels, np.int8)

        self.decoded = 0
        self.perfect = 0
        self.reacquisitions = 0          # blocks that ran the re-acquire path

        # per-channel quantization step (int8 buffers; device + host mirror)
        self._scale_np = np.full(channels, INT8_SCALE, np.float32)
        self._scale = self._put(self._scale_np)
        self.timing = bool(timing)
        self.block_stats: list = []
        self._burst_salvage = bool(single_frame_burst)

    # -- device programs (plain torch on the engine's device) ------------ #

    def _put(self, arr) -> torch.Tensor:
        """A device copy of a host array (never a view of it)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def _get(self, out):
        """Fetch one result (a dict or tuple of tensors) to the host: one
        synchronize, then the copies."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if isinstance(out, dict):
            return {k: to_host(v) for k, v in out.items()}
        return tuple(to_host(v) for v in out)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.channels, self.window // self.sps,
                            2 * self.sps), dtype=self.dtype,
                           device=self.device)

    def _conv(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """Wire-scale pairs -> the buffer domain (int8: round half to even
        of x / scale, clipped to +-127)."""
        if self._int8:
            q = torch.round(x.to(torch.float32) / scale[:, None, None])
            return torch.clamp(q, -127, 127).to(torch.int8)
        return x.to(self.dtype)

    def _cplx(self, buf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """(C, R, 80) rows -> (C, R*40) complex64: a view of float32 rows;
        bf16 and int8 rows widened, int8 rescaled to wire scale."""
        f = buf.reshape(self.channels, -1, 2)
        if f.dtype != torch.float32:
            f = f.to(torch.float32)
        if self._int8:
            f = f * scale[:, None, None]
        return torch.view_as_complex(f)

    def _pairs_c(self, x: torch.Tensor) -> torch.Tensor:
        """(C, t) complex chunk -> (C, t, 2) wire-scale pairs."""
        return torch.view_as_real(x).to(self._wire)

    def _append(self, x: torch.Tensor) -> None:
        """Write (C, t, 2) wire-scale pairs (t a multiple of 40) as rows at
        the buffer's fill point.  The caller appends only what fits."""
        rows = self._conv(x, self._scale).reshape(self.channels, -1,
                                                  2 * self.sps)
        row = self._count // self.sps
        if row + rows.shape[1] > self._buf.shape[1]:
            raise RuntimeError(
                f"append of {rows.shape[1]} rows at row {row} overruns the "
                f"{self._buf.shape[1]}-row window")
        self._buf[:, row:row + rows.shape[1]] = rows

    def _slide(self) -> None:
        """Drop the advance's rows from the window head; zero the tail (a
        new buffer, as overlapping in-place row moves are undefined)."""
        adv = self.advance // self.sps
        pad = torch.zeros((self.channels, adv, 2 * self.sps),
                          dtype=self.dtype, device=self.device)
        self._buf = torch.cat([self._buf[:, adv:], pad], dim=1)

    def _steady(self, buf, p0, foff, scale, frac, n_frames: int):
        return rx_locked_steady(buf, p0, foff, n_frames,
                                scale=scale if self._int8 else None,
                                frac=frac)

    def _reacquire(self, buf, p0, foff, keep, scale, frac):
        return rx_locked_reacquire(self._cplx(buf, scale), p0, foff, keep,
                                   self.block_frames, frac_old=frac)

    def _retime(self, buf, p0, foff, scale):
        return rx_locked_retime(self._cplx(buf, scale), p0, foff,
                                n_frames=self.block_frames)

    # ------------------------------------------------------------------ #

    def feed(self, samples):
        """samples: (C, n) complex (cast to complex64) OR (C, n, 2) IQ
        pairs (float32, int16 wire format or bfloat16; cast to the buffer
        dtype during the append); numpy or tensor, copied to the engine's
        device.  Any n is accepted; appends are row-aligned (40 samples),
        so a sub-row tail pends until the next feed/flush.  Returns decoded
        frame tuples for every full window completed by this feed."""
        if samples.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        ilv = samples.ndim == 3
        x = torch.as_tensor(samples)
        x = (x.to(self.device) if ilv
             else x.to(self.device, torch.complex64))
        if self._pend is not None:
            # sub-row carry from the previous feed: unify in the pairs
            # domain (rare — only non-40-aligned feeds reach here)
            if not ilv:
                x, ilv = self._pairs_c(x), True
            elif x.dtype != self._pend.dtype:
                x = x.to(self._pend.dtype)
            x = torch.cat([self._pend, x], dim=1)
            self._pend = None
        out = []
        off = 0
        n = x.shape[1]
        while off < n:
            room = self.window - self._count        # always row-aligned
            take = min(room, n - off)
            if take < room:
                take -= take % self.sps             # sub-row tail pends
            if take:
                chunk = x[:, off:off + take]
                self._append(chunk if ilv else torch.view_as_real(chunk))
                self._count += take
                off += take
            if self._count >= self.window:
                out.extend(self._process())
            elif take == 0:
                break
        if off < n:
            tail = x[:, off:] if ilv else self._pairs_c(x[:, off:])
            # a copy: on the CPU the feed may be a view of the caller's array
            self._pend = tail.to(self._wire, copy=True)
        return out

    def flush(self):
        """Process the buffered tail (zero-padded); frames whose payload
        would extend into the padding are rejected, not emitted corrupt."""
        if self._pend is not None:       # zero-pad the sub-row carry in
            p = self._pend.shape[1]
            self._append(F.pad(self._pend, (0, 0, 0, self.sps - p)))
            self._count += p
            self._pend = None
        min_n = self.spf + CONFIG.samples_per_symbol
        if self._count < min_n:
            results = []
        else:
            results = self._process(valid_limit=self._count)
        self._abs_base += self._count
        self._count = 0
        self._buf = self._zeros()
        return results

    # ------------------------------------------------------------------ #

    def _process(self, valid_limit: int | None = None):
        out, wrap, p0w, tag = self._run_block(self._buf)
        results = self._resolve_block(out, self._buf, valid_limit, wrap,
                                      p0w, tag, self._abs_base)
        if valid_limit is None:
            self._advance_window()
        return results

    def _run_block(self, buf):
        """Retime (if flagged) and launch this window's program with the
        current host state.  Returns (out_dev, wrap, p0_wrapped, tag);
        mutates p0/refresh bookkeeping, not the lock lifecycle."""
        # timing refresh: micro-adjust p0 for flagged locked channels from
        # the dense sync correlation around the next expected sync.  Lock
        # state is untouched — a faded signal yields delta 0 and the
        # flywheel applies.
        put = self._put_state
        wrap = np.zeros(self.channels, bool)
        p0_wrapped = self.p0
        retune = self.refresh & self.locked
        if retune.any():
            out_rt = self._retime(buf, put("p0", self.p0),
                                  put("foff", self.freq_offset),
                                  self._scale)
            delta, frac_new, fold = self._get(out_rt)
            delta = np.where(retune, delta, 0).astype(np.int32)
            # energy gate: the retime window is anchored one frame ahead of
            # p0, so at a burst tail (or in a deep fade) it folds silence;
            # a near-zero-energy fold against the channel's per-window
            # average would walk the grid off the final frame
            with np.errstate(invalid="ignore", divide="ignore"):
                avg = self._fold_acc.sum(axis=1) \
                    / np.maximum(self._fold_w, 1e-9)
            weak = (self._fold_ok & (self._fold_w > 0)
                    & (fold.sum(axis=1) < 0.3 * avg))
            retune = retune & ~weak
            # trust region: a drift-sized jump needs sign-consistent
            # confirmation by the next retime before the fresh single-window
            # estimate is adopted; noise-regime folds accumulate and the
            # grid re-estimates from the deep average
            cur = self.p0.astype(np.float64) + self.frac
            est_one = (self.p0 + delta).astype(np.float64) + frac_new
            dev = est_one - cur
            big = np.abs(dev) > self._TIMING_TRUST
            sgn = np.sign(dev).astype(np.int8)
            half = self.sps // 2
            est_acc0 = (self.p0 - half).astype(np.float64) \
                + fold_est_np(self._fold_acc)
            # a deep accumulator vetoes a sign-confirmed big jump unless the
            # deep estimate leans the same way by more than half a trust
            # radius (magnitude, not just sign: with no drift its sign is a
            # coin flip)
            deep = self._fold_ok & (self._fold_w >= self._FOLD_DEEP)
            agree = ((np.sign(est_acc0 - cur).astype(np.int8) == sgn)
                     & (np.abs(est_acc0 - cur) > 0.5 * self._TIMING_TRUST))
            adopt = retune & big & (sgn == self._big_dir) & (~deep | agree)
            hold = retune & big & ~adopt
            self._big_dir[hold] = sgn[hold]
            self._big_dir[retune & ~big] = 0
            # adoption re-seeds the accumulator; held and noise-regime
            # folds both accumulate
            seed = adopt | (retune & ~self._fold_ok)
            accum = retune & ~seed
            self._fold_acc[seed] = fold[seed]
            self._fold_w[seed] = 1.0
            # grow-into-EMA: a uniform running sum until the weight reaches
            # the EMA's steady-state depth 1/(1-D), then the fixed decay
            d_eff = np.where(
                self._fold_w < 1.0 / (1.0 - self._FOLD_DECAY) - 1.0,
                1.0, self._FOLD_DECAY)
            self._fold_acc[accum] = (d_eff[accum, None]
                                     * self._fold_acc[accum] + fold[accum])
            self._fold_w[accum] = d_eff[accum] * self._fold_w[accum] + 1
            self._fold_ok |= retune
            est_acc = (self.p0 - half).astype(np.float64) \
                + fold_est_np(self._fold_acc)
            est = np.where(adopt, est_one, est_acc)
            # a held channel with a shallow accumulator takes a step toward
            # the fresh estimate clipped to the trust radius; deep channels
            # follow the deep estimate
            step = cur + np.clip(dev, -self._TIMING_TRUST,
                                 self._TIMING_TRUST)
            est = np.where(hold & ~deep, step, est)
            blend = np.where(retune, est, cur)
            p0n = np.floor(blend).astype(np.int32)
            frac_n = (blend - p0n).astype(np.float32)
            # p0n < 0: the drifted grid steps back across the window start.
            # The straddling frame is still inside this window, on the old
            # grid at slot p0 + bf*spf: process this block on the old grid
            # with one extra slot and ownership extended by a frame, then
            # advance the corrected grid one frame for the next block
            wrap = p0n < 0
            moved = retune & (p0n != self.p0)
            # keep the accumulator aligned with the adopted grid: a p0 move
            # by d shifts the apex by -d bins (wraps re-anchor next refresh)
            for c in np.flatnonzero(moved):
                if wrap[c]:
                    self._fold_ok[c] = False
                    continue
                d = int(p0n[c]) - int(self.p0[c])
                if abs(d) >= self._fold_acc.shape[1]:
                    self._fold_ok[c] = False
                else:
                    self._fold_acc[c] = np.roll(self._fold_acc[c], -d)
                    if d > 0:
                        self._fold_acc[c, -d:] = 0.0
                    elif d < 0:
                        self._fold_acc[c, :-d] = 0.0
            self.p0 = np.where(wrap, self.p0, p0n).astype(np.int32)
            p0_wrapped = np.where(wrap, p0n + self.spf,
                                  self.p0).astype(np.int32)
            self.refreshes += int(moved.sum())
            self.metric_ema[moved] = np.nan  # fresh grid -> fresh baseline
            # adopt the blended frac for every retuned non-wrap channel (a
            # wrap processes this block on the old grid)
            adopt = retune & ~wrap
            self.frac = np.where(adopt, frac_n,
                                 self.frac).astype(np.float32)
        self.refresh[:] = False

        if self.locked.all():
            n_frames = self.block_frames + (1 if wrap.any() else 0)
            out = self._steady(buf, put("p0", self.p0),
                               put("foff", self.freq_offset), self._scale,
                               put("frac", self.frac), n_frames)
            tag = "steady"
        else:
            # mixed lock states never use the extra-slot program; a wrap
            # coinciding with another channel's re-acquisition forfeits the
            # straddler (rare corner; the grid still corrects)
            out = self._reacquire(buf, put("p0", self.p0),
                                  put("foff", self.freq_offset),
                                  put("keep", self.locked), self._scale,
                                  put("frac", self.frac))
            tag = "reacquire"
        return out, wrap, p0_wrapped, tag

    def _resolve_block(self, out, buf, valid_limit, wrap, p0_wrapped, tag,
                       base):
        """Fetch one block's results and run the host sync lifecycle."""
        t_res = time.monotonic() if self.timing else None
        self._fetch_ms = 0.0
        if tag == "reacquire":
            self.reacquisitions += 1
        self._want_refresh[:] = False
        prev_locked = self.locked.copy()
        results = self._emit(out, valid_limit, base, own_extra=wrap)
        self.p0 = np.where(wrap, p0_wrapped, self.p0).astype(np.int32)

        # a channel that dropped lock during this block is re-hunted over
        # THIS window (the reference goes LOCKED -> HUNTING at the drop
        # sample and scans on, src/opv-demod.cpp:695-713), so a burst
        # starting later in the same window keeps its first frame
        dropped = prev_locked & ~self.locked
        if dropped.any():
            self.reacquisitions += 1
            out2 = self._reacquire(buf, self._put_state("p0", self.p0),
                                   self._put_state("foff", self.freq_offset),
                                   self._put_state("keep", ~dropped),
                                   self._scale,
                                   self._put_state("frac", self.frac))
            results.extend(self._emit(out2, valid_limit, base, only=dropped,
                                      min_pos=self._dropped_at))
        warm = max(4.0, self._FOLD_WARM_FOLDS / self.block_frames)
        with np.errstate(invalid="ignore"):
            warming = ((self._fold_w < warm)
                       & (self.metric_ema > self._WARM_METRIC_MIN))
        # miss > 0 (flywheel riding at block end): the window's trailing
        # frame intervals hold no signal, so a retime fold over them would
        # be garbage
        self.refresh = ((self._want_refresh | warming)
                        & self.locked & (self.miss == 0))
        # the fold accumulator is anchored to a locked channel's stable
        # grid: any lock transition re-anchors p0
        stable = self.locked & prev_locked
        self._fold_ok &= stable
        self._fold_w[~stable] = 0.0
        self._big_dir[~stable] = 0
        if t_res is not None:
            total_ms = (time.monotonic() - t_res) * 1e3
            self.block_stats.append(dict(
                tag=tag,
                device_wait_ms=round(self._fetch_ms, 3),
                host_ms=round(total_ms - self._fetch_ms, 3)))
        return results

    def _put_state(self, name, arr):
        """Device copy of a small host lock-state vector, cached on its
        content: steady streaming re-sends identical p0/freq_offset/frac
        every block, and in-place host updates change the bytes, so they
        refresh the copy."""
        key = arr.tobytes()
        ent = self._state_cache.get(name)
        if ent is not None and ent[0] == key:
            return ent[1]
        dev = self._put(arr)
        self._state_cache[name] = (key, dev)
        return dev

    def _advance_window(self):
        self._slide()
        self._count -= self.advance
        self._abs_base += self.advance
        # grid positions repeat every frame, so after advancing by an exact
        # frame multiple the same sync sits at p0 mod 86,720
        self.p0 = self.p0 % self.spf

    def _emit(self, out, valid_limit, base, only=None, min_pos=None,
              own_extra=None):
        """Run the host-side sync lifecycle over one block result.

        only: bool (C,) — process just these channels (re-hunt second pass).
        min_pos: int (C,) — reject frames before this window position (the
        slot where lock was dropped).
        own_extra: bool (C,) — extend this channel's block ownership by one
        frame (drift-wrap straddler, see _run_block).
        base: absolute stream index of this block's window start."""
        t_fetch = time.monotonic() if self.timing else None
        out = self._get(out)             # one fetch for the whole result
        if t_fetch is not None:
            self._fetch_ms += (time.monotonic() - t_fetch) * 1e3
        burst_only = out.get("burst_only")   # reacquire blocks only
        q = out["sync_q"]
        raw = out["sync_raw"]
        ok = out["decode_ok"]
        metrics = out["metrics"]
        frames = out["frames"]
        p0 = out["p0"]
        foff = out["freq_offset"]
        frac = out["frac"]
        chans = range(self.channels) if only is None else np.flatnonzero(only)
        self._dropped_at = np.zeros(self.channels, np.int64)
        for c in chans:
            self.p0[c] = p0[c]
            self.freq_offset[c] = foff[c]
            self.frac[c] = frac[c]

        vlim = self.window if valid_limit is None else valid_limit
        # a frame is owned by this block only if its sync starts before the
        # slide amount; later slots reappear (at pos % spf) next block
        own_end = self.advance if valid_limit is None else vlim
        extent = self.spf + CONFIG.samples_per_symbol  # sync..payload end
        results = []
        n_slots = frames.shape[1]
        for c in chans:
            own_c = own_end
            if own_extra is not None and own_extra[c]:
                own_c = own_end + self.spf
            for k in range(n_slots):
                pos = int(self.p0[c]) + k * self.spf
                if pos >= own_c or pos + extent > vlim:
                    continue           # next block's slot / incomplete tail
                if min_pos is not None and pos < min_pos[c]:
                    continue           # precedes this channel's lock drop
                emit = False
                if self.locked[c]:
                    # LOCKED re-check (src/opv-demod.cpp:695-713)
                    if q[c, k] >= CONFIG.sync_locked_norm_thresh:
                        self.miss[c] = 0
                        emit = True
                        m = int(metrics[c, k])
                        ema = self.metric_ema[c]
                        if not np.isfinite(ema):
                            self.metric_ema[c] = m
                        else:
                            if (q[c, k] < self.REFRESH_Q
                                    or (m > ema + self.REFRESH_METRIC_RISE
                                        and m > self.REFRESH_METRIC_MIN)):
                                self._want_refresh[c] = True
                            self.metric_ema[c] = ((1 - self._EMA_ALPHA) * ema
                                                  + self._EMA_ALPHA * m)
                    elif self.miss[c] < CONFIG.sync_miss_limit:
                        self.miss[c] += 1      # flywheel frame
                        emit = True
                    else:
                        self.locked[c] = False
                        self.miss[c] = 0
                        self._dropped_at[c] = pos
                else:
                    # HUNTING thresholds (src/opv-demod.cpp:783-786)
                    if (q[c, k] >= CONFIG.sync_hunt_norm_thresh
                            and raw[c, k] >= CONFIG.sync_hunt_raw_thresh):
                        if burst_only is not None and burst_only[c]:
                            # isolated single-frame burst: emit without
                            # locking (the reference's VERIFYING state emits
                            # it too, opv-demod.cpp:657-680)
                            emit = self._burst_salvage
                        else:
                            self.locked[c] = True
                            self.miss[c] = 0
                            emit = True
                if emit and ok[c, k]:
                    self.decoded += 1
                    if metrics[c, k] == 0:
                        self.perfect += 1
                    results.append((c, bytes(frames[c, k]),
                                    int(metrics[c, k]), float(q[c, k]),
                                    base + pos))
        return results

    def stats(self) -> dict:
        """Aggregate the per-block timing records (timing=True): block
        counts by program tag, device-wait vs host-lifecycle ms split
        (mean/max), plus the lifecycle counters."""
        out = dict(decoded=self.decoded, perfect=self.perfect,
                   reacquisitions=self.reacquisitions,
                   refreshes=self.refreshes)
        if not self.block_stats:
            return out
        tags: dict = {}
        for b in self.block_stats:
            tags[b["tag"]] = tags.get(b["tag"], 0) + 1
        dw = [b["device_wait_ms"] for b in self.block_stats]
        hm = [b["host_ms"] for b in self.block_stats]
        out.update(
            blocks=len(dw), blocks_by_program=tags,
            device_wait_ms_mean=round(sum(dw) / len(dw), 3),
            device_wait_ms_max=round(max(dw), 3),
            host_ms_mean=round(sum(hm) / len(hm), 3),
            host_ms_max=round(max(hm), 3))
        return out

    # ------------------------------------------------------------------ #
    # checkpoint/resume (stream/state.py)

    def state_tree(self) -> dict:
        """The engine's whole state as a flat dict (the JAX package's keys
        and layouts): buf and pend are tensors on the device (copies), the
        rest numpy."""
        # pend is stored zero-padded to one full row + its true length so
        # the leaf shapes are feed-history independent; it lives at WIRE
        # scale (float32 for int8 buffers)
        pend = torch.zeros((self.channels, self.sps, 2), dtype=self._wire,
                           device=self.device)
        pend_len = 0
        if self._pend is not None:
            pend_len = self._pend.shape[1]
            pend = F.pad(self._pend.to(self._wire),
                         (0, 0, 0, self.sps - pend_len))
        return dict(
            buf=self._buf.clone(), count=np.int64(self._count),
            pend=pend, pend_len=np.int64(pend_len),
            abs_base=np.int64(self._abs_base),
            p0=self.p0.copy(), frac=self.frac.copy(),
            freq_offset=self.freq_offset.copy(),
            locked=self.locked.copy(), miss=self.miss.copy(),
            refresh=self.refresh.copy(), metric_ema=self.metric_ema.copy(),
            fold_acc=self._fold_acc.copy(), fold_ok=self._fold_ok.copy(),
            fold_w=self._fold_w.copy(), big_dir=self._big_dir.copy(),
            scale=self._scale_np.copy(),
            decoded=np.int64(self.decoded), perfect=np.int64(self.perfect),
        )

    def load_state_tree(self, tree) -> None:
        """Adopt a state produced by state_tree() of either package (e.g.
        via load_state).  Accepts all three buffer layouts: (C, window/40,
        80) window rows (current), (C, window, 2) IQ pairs, and (C, window)
        complex (pre-wire-form checkpoints), in any buffer dtype."""
        buf = torch.as_tensor(tree["buf"]).to(self.device)
        # the checkpoint's quantization step (per channel); pre-AGC
        # checkpoints carry no scale field — their int8 buffers are at the
        # fixed wire-full-scale step
        tree_scale = np.asarray(
            tree.get("scale", np.full(self.channels, INT8_SCALE)),
            np.float32)
        if buf.dim() == 2:
            buf = torch.view_as_real(buf).to(torch.float32)
        if buf.shape[-1] == 2:           # pairs -> window rows
            buf = buf.reshape(self.channels, -1, 2 * self.sps)
        # cross-dtype adoption: int8 buffers hold wire/scale values, float
        # buffers hold wire-scale values — rescale across the domains
        if buf.dtype == torch.int8 and not self._int8:
            buf = buf.to(torch.float32) * self._put(tree_scale)[:, None, None]
        if self._int8:
            self._scale_np = tree_scale.copy()
            self._scale = self._put(self._scale_np)
        if self._int8 and buf.dtype != torch.int8:
            # wire-scale floats -> quantized at the adopted step
            self._buf = self._conv(buf, self._scale).contiguous()
        else:
            self._buf = buf.to(self.dtype, copy=True).contiguous()
        count = int(tree["count"])
        self._pend = None
        rem = count % self.sps
        if rem:
            # pre-windowed checkpoints could hold a sub-row count; move the
            # partial row's samples to the pend carry (the next append
            # rewrites that row with pend + new data — identical values)
            pairs = self._buf.reshape(self.channels, -1, 2)
            self._pend = pairs[:, count - rem:count].to(self._wire,
                                                       copy=True)
            if self._int8:               # buffer domain -> wire scale
                self._pend = self._pend * self._scale[:, None, None]
            count -= rem
        self._count = count
        if "pend" in tree and int(tree.get("pend_len", 0)):
            p = int(tree["pend_len"])
            assert self._pend is None    # aligned count when pend was saved
            self._pend = torch.as_tensor(tree["pend"]).to(
                self.device)[:, :p].to(self._wire, copy=True)
        self._abs_base = int(tree["abs_base"])
        self.p0 = np.asarray(tree["p0"], np.int32).copy()
        self.frac = np.asarray(tree.get("frac", np.zeros(self.channels)),
                               np.float32).copy()
        self.freq_offset = np.asarray(tree["freq_offset"], np.float32).copy()
        self.locked = np.asarray(tree["locked"], bool).copy()
        self.miss = np.asarray(tree["miss"], np.int32).copy()
        if "refresh" in tree:
            self.refresh = np.asarray(tree["refresh"], bool).copy()
        if "metric_ema" in tree:
            self.metric_ema = np.asarray(tree["metric_ema"],
                                         np.float64).copy()
        if "fold_acc" in tree:
            self._fold_acc = np.asarray(tree["fold_acc"], np.float64).copy()
            self._fold_ok = np.asarray(tree["fold_ok"], bool).copy()
        else:                            # older checkpoint: cold accumulator
            self._fold_acc[:] = 0.0
            self._fold_ok[:] = False
        if "big_dir" in tree:
            self._big_dir = np.asarray(tree["big_dir"], np.int8).copy()
        else:
            self._big_dir[:] = 0
        if "fold_w" in tree:
            self._fold_w = np.asarray(tree["fold_w"], np.float64).copy()
        else:
            self._fold_w[:] = 0.0
        self.decoded = int(tree["decoded"])
        self.perfect = int(tree["perfect"])
