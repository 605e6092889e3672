"""Locked-grid streaming engine: the production multichannel receiver of
the port.

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
lifecycle is the same numpy code.  pipeline=True launches block N before
block N-1's results are resolved (its fetch overlaps block N on the card)
and relaunches N when the resolve proves the predicted program wrong, so
float buffers emit the synchronous engine's tuples; eager=True serves
pure-steady blocks as soon as their owned slots are buffered; int8
buffers adapt their step per channel (AGC); hunt_stride=2 hunts at half
the dense resolution.

mesh= splits the bank over a mesh's 'ch' axis (parallel/mesh.py): every
device program runs once per 'ch' shard, on that shard's channels and
device (_shard_map, the counterpart of the JAX engine's jit_s), and the
per-channel results come back per shard and are joined in channel order;
the host lifecycle is the same code, so the tuples are the unsharded
engine's.

On a CUDA device every block's outputs are copied to pinned host memory
right behind its launch, and the host waits on an event recorded after
those copies, never on the whole device; host arrays reach the card
through pinned staging without blocking (_to_device).  So a launch never
waits for the work queued before it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.locked import (INT8_SCALE, fold_est_np,
                                     rx_locked_reacquire,
                                     rx_locked_reacquire_strided,
                                     rx_locked_retime, rx_locked_steady)
from opv_tpu_torch.parallel.mesh import channel_shards, process_rank
from opv_tpu_torch.parallel.multihost import all_gather
from opv_tpu_torch.stream.state import to_device, to_host

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}

#: the block outputs the host lifecycle reads (_emit)
_FETCHED = ("frames", "metrics", "sync_q", "sync_raw", "decode_ok", "p0",
            "freq_offset", "frac", "burst_only")

#: the engine's device programs: what a mesh engine runs once per shard
_PROGRAMS = ("_zeros", "_with_pend", "_append", "_tail", "_row_of",
             "_slide", "_chain_p0", "_steady", "_reacquire", "_retime",
             "_stat_p", "_stat_c", "_requant")


class _Shards:
    """A per-channel value of a mesh engine: one tensor per 'ch' shard this
    process holds (`parts`, in channel order)."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self):
        """The local shards' rows, then the shards' common trailing dims."""
        first = self.parts[0].shape
        return (sum(p.shape[0] for p in self.parts),) + tuple(first[1:])


def _regroup(outs: list):
    """Per-shard program outputs -> one output of _Shards (tuples and dicts
    element by element; None stays None)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_regroup([o[i] for o in outs]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _regroup([o[k] for o in outs]) for k in first}
    return _Shards(outs)


class _Fetch:
    """Device values (`dev`: tensors, or _Shards of a mesh engine) and
    their host copies, the `keys` ones (a block's outputs by default).

    On a CUDA device the copies are queued on the stream right behind the
    launch, non-blocking into pinned host tensors, with an event recorded
    after them (one per device): waiting for this block never waits for a
    block queued after it.  (The caching host allocator reuses a freed
    pinned block once its copy has run, so steady streaming allocates no
    new pinned memory.)  On the CPU the copies are taken when asked for.
    `join` turns each key's per-shard host arrays into the whole bank's
    (None: one part, taken as it is)."""

    def __init__(self, dev: dict, keys=_FETCHED, join=None):
        self.dev = dev
        self._join = join
        # new lists: the device values stay as they are (the pipelined
        # engine chains p0, freq_offset and frac from them)
        self._parts = {k: list(dev[k].parts if isinstance(dev[k], _Shards)
                               else [dev[k]]) for k in keys if k in dev}
        self._events = []
        self._done = None
        first = next(iter(self._parts.values()))
        for j, t0 in enumerate(first):
            if not t0.is_cuda:
                continue
            for parts in self._parts.values():
                t = parts[j]
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                parts[j] = pinned.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t0.device))
            self._events.append(event)

    def wait(self) -> dict:
        """The fetched values as host numpy arrays (of the whole bank)."""
        if self._done is None:
            for event in self._events:
                event.synchronize()
            host = {k: [p.numpy() if p.is_pinned() else to_host(p)
                        for p in parts] for k, parts in self._parts.items()}
            self._done = (self._join(host) if self._join is not None
                          else {k: v[0] for k, v in host.items()})
        return self._done


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

    #: int8 AGC: re-evaluate the per-channel quantization step every this
    #: many resolved blocks (and on every lock transition)
    _AGC_BLOCKS = 8
    #: target step: clip at ~3.5 sigma of the input unless the true peak is
    #: smaller (a clean constant-envelope signal: the step follows the peak,
    #: and a wire-full-scale signal gets INT8_SCALE exactly)
    _AGC_SIGMA = 3.5
    #: hysteresis: re-quantize only when the desired step left [1/1.4, 1.4]
    #: times the current one (steady streams never rescale)
    _AGC_BAND = 1.4

    def __init__(self, channels: int, block_frames: int = 4,
                 dtype: str = "auto", pipeline: bool = False,
                 agc: bool = True, mesh=None,
                 single_frame_burst: bool = True, timing: bool = False,
                 eager: bool = False, hunt_stride: int = 1,
                 device="cuda"):
        """dtype: the window-row buffer's element type, "float32",
        "bfloat16" or "int8" (samples / step, rounded half to even and
        clipped to +-127).  "auto" means float32 in the port until the
        buffer dtype for CUDA is decided (ROADMAP queue 2).

        agc (int8 buffers only): adapt the quantization step per channel to
        the measured input level, step = min(peak, 3.5 x rms) / 127, from
        feed-time statistics: once on the first feed (before anything is
        quantized), then every _AGC_BLOCKS resolved blocks and on every
        lock transition, adopted outside the _AGC_BAND hysteresis.  An
        adoption re-quantizes the buffered window, round(buf x old/new),
        into a new tensor.  agc=False keeps the fixed INT8_SCALE step (or
        the per-channel step of a loaded checkpoint).

        pipeline: launch block N with the last resolved state before block
        N-1's results are resolved (p0, freq_offset and frac chain on the
        device from N-1's outputs), so N-1's fetch and host lifecycle
        overlap block N on the card.  Where the resolve shows the launch was
        wrong (a lock changed, or a timing refresh is due), block N is
        launched again on its retained window with the exact state, so
        float buffers emit the synchronous engine's tuples.  With int8 AGC
        the level statistics then span one more feed at each adoption
        point than the synchronous engine's, as in the JAX package.
        state_tree() raises while a block is in flight (flush() first).

        eager (low-latency serving, block_frames <= sync_miss_limit): a
        pure-steady block (all channels locked, no flywheel miss, no
        refresh due) is processed as soon as every owned slot's samples
        are buffered (count >= max(p0) + advance + one symbol) instead of at
        window completion; a slot's outputs depend only on samples before
        pos + spf + 40, so the tuples are the same, one window tail earlier.
        With int8 AGC the updates then read other feeds' statistics, so
        payloads and positions stay and other tuple fields may not (as in
        the JAX package).  Larger blocks keep the window gate.  Exclusive
        with pipeline.

        hunt_stride: the re-acquisition's dense hunt stride in samples
        (rx_locked_reacquire_strided for 2, 4, ...; it must divide 40).

        device: where the buffer lives and every program runs; "cuda"
        runs the hand-written kernels (and raises without a card), "cpu"
        their plain twins.  Host feeds are copied there.

        single_frame_burst: emit an isolated single-frame burst's frame
        without locking (reference semantics, opv-demod.cpp:657-680, minus
        the false-lock flywheel cost); off, such bursts are dropped.

        timing: record per block the program tag, the time spent waiting
        on the block's results (device_wait_ms: in pipeline mode the wait
        left after the overlap) and the host lifecycle time (host_ms) in
        block_stats; stats() aggregates them.

        mesh: a parallel.mesh.Mesh with a 'ch' axis (channels divisible by
        its size); it replaces device=.  The window buffer is one (C/nch,
        window/40, 80) tensor per 'ch' shard, on the first device of that
        shard's row of the mesh (other axes are unused: the JAX engine
        replicates the work over them, which computes the same values), and
        every device program runs per shard: append, slide, the steady,
        re-acquire and retime programs, the AGC statistics and requant.
        Per-channel scalars and frame bytes come back per shard through the
        same event-gated pinned copies and are joined in channel order, so
        the host lifecycle, and the emitted tuples, are the unsharded
        engine's.  feed() also takes a list of per-shard pieces, each on
        its shard's device.  Across processes (parallel/multihost.py) every
        process feeds the identical full chunk and keeps its own shards;
        the per-channel results are gathered over gloo, so every process
        runs the same lifecycle and emits the same tuples.  state_tree()
        is placement-agnostic: a sharded checkpoint loads into an unsharded
        engine, and back."""
        if hunt_stride > 1 and CONFIG.samples_per_symbol % hunt_stride:
            raise ValueError(f"hunt_stride {hunt_stride} must divide the "
                             f"{CONFIG.samples_per_symbol}-sample symbol")
        if eager and pipeline:
            raise ValueError("eager (low-latency) and pipeline (throughput) "
                             "modes are mutually exclusive")
        if dtype == "auto":
            dtype = "float32"
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)} or "
                             f"'auto', got {dtype!r}")
        self.dtype = _DTYPES[dtype]
        self._int8 = self.dtype == torch.int8
        self.mesh = mesh
        if mesh is not None:
            shards = channel_shards(mesh, channels)
            me = process_rank()
            self._spans = [(lo, hi) for lo, hi, _, r in shards if r == me]
            self._devices = [d for _, _, d, r in shards if r == me]
            self._multiproc = mesh.multiprocess
            self.device = self._devices[0]
        else:
            self.device = torch.device(device)
        if any(d.type == "cuda" for d in self._all_devices()) \
                and not torch.cuda.is_available():
            raise RuntimeError(
                "LockedStreamDemodulator(device='cuda') needs a CUDA device; "
                "pass device='cpu' to run the plain twins on the host")
        # sub-row pend carry stays at WIRE scale (int8's buffer domain is
        # quantized; re-quantizing a quantized tail would double-divide)
        self._wire = torch.float32 if self._int8 else self.dtype

        self.channels = channels
        self.block_frames = block_frames
        self.hunt_stride = hunt_stride
        spf = CONFIG.samples_per_frame
        self.spf = spf
        self.advance = block_frames * spf
        # window: p0 < 86,720 plus block_frames full frames plus the slack
        # (sync window + correlator tail + margin) that the hunt's
        # next-frame verification needs for every sync this block owns
        self.window = (block_frames + 1) * spf + 1040
        self.sps = CONFIG.samples_per_symbol     # row width in samples
        assert self.window % self.sps == 0 and self.advance % self.sps == 0

        if mesh is not None:
            # every device program, once per 'ch' shard
            for name in _PROGRAMS:
                setattr(self, name, self._shard_map(getattr(self, name)))
            self._where = _Shards([(hi - lo, d) for (lo, hi), d
                                   in zip(self._spans, self._devices)])
        else:
            self._where = (channels, self.device)
        self._buf = self._zeros(self._where)
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

        # int8 AGC: per-channel quantization step (wire units per int8 LSB;
        # device + host mirror) and the feed-time level statistics (on the
        # device; copied to the host only for an AGC update)
        self._agc = bool(agc) and self._int8
        self._scale_np = np.full(channels, INT8_SCALE, np.float32)
        self._scale = self._put(self._scale_np)
        self._stat_gen = 0               # bumped at every statistics reset
        self._reset_stats()
        self._blocks = 0                 # resolved blocks (AGC cadence)
        self._agc_primed = not self._agc

        self._eager = bool(eager) and block_frames <= CONFIG.sync_miss_limit
        self.pipeline = bool(pipeline)
        self._pending = None            # in-flight block (pipeline mode)
        self.timing = bool(timing)
        self.block_stats: list = []
        self._burst_salvage = bool(single_frame_burst)

    # -- device programs (plain torch on the engine's device) ------------ #
    #
    # Each program (_PROGRAMS) computes on the tensors it is given, of any
    # number of channels: under a mesh, _shard_map runs it once per 'ch'
    # shard.

    def _all_devices(self) -> list:
        return self._devices if self.mesh is not None else [self.device]

    def _shard_map(self, fn):
        """fn, a program over one shard's tensors, as a program over the
        engine's: each _Shards argument gives fn its shard's part, any
        other argument is passed as it is; every shard is launched before
        any is waited on.  The counterpart of the JAX engine's jit_s."""
        def run(*args):
            return _regroup([fn(*(a.parts[j] if isinstance(a, _Shards)
                                  else a for a in args))
                             for j in range(len(self._spans))])
        return run

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """x on the engine's device (stream/state.py::to_device)."""
        return to_device(x, self.device)

    def _put(self, arr):
        """A device copy of a host (C, ...) array (never a view of it); a
        mesh engine's is split over its shards."""
        arr = np.asarray(arr)
        if self.mesh is None:
            return self._to_device(torch.tensor(arr))
        return _Shards([to_device(torch.tensor(arr[lo:hi]), d)
                        for (lo, hi), d in zip(self._spans, self._devices)])

    def _join(self, host: dict) -> dict:
        """{key: the local shards' host arrays} -> {key: the whole bank's
        array}: concatenated in channel order, across processes gathered
        over gloo first."""
        if not self._multiproc:
            return {k: np.concatenate(v) for k, v in host.items()}
        got = all_gather((self._spans, host))
        out = {}
        for k in host:
            pieces = sorted((lo, arr) for spans, h in got
                            for (lo, _), arr in zip(spans, h[k]))
            out[k] = np.concatenate([arr for _, arr in pieces])
        return out

    def _get(self, out):
        """Fetch a tuple of device values to the host now: one synchronize,
        then the copies (block results go through _Fetch instead)."""
        for d in self._all_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        if self.mesh is None:
            return tuple(to_host(v) for v in out)
        host = self._join({i: [to_host(p) for p in v.parts]
                           for i, v in enumerate(out)})
        return tuple(host[i] for i in range(len(out)))

    def _full(self, v) -> torch.Tensor:
        """A copy of a per-channel device value as one (C, ...) tensor on
        the engine's (first) device: a mesh engine's shards joined."""
        if self.mesh is None:
            return v.clone()
        if not self._multiproc:
            return torch.cat([p.to(self.device) for p in v.parts])
        got = all_gather((self._spans, [p.cpu() for p in v.parts]))
        pieces = sorted((lo, t) for spans, parts in got
                        for (lo, _), t in zip(spans, parts))
        return torch.cat([t for _, t in pieces]).to(self.device)

    def _place(self, t: torch.Tensor):
        """A whole-bank (C, ...) tensor as the engine's value: on its
        device, or split over the mesh engine's shards."""
        if self.mesh is None:
            return t.to(self.device)
        return _Shards([t[lo:hi].to(d).contiguous()
                        for (lo, hi), d in zip(self._spans, self._devices)])

    def _zeros(self, where) -> torch.Tensor:
        """An empty window for (channels, device) `where`."""
        c, dev = where
        return torch.zeros((c, self.window // self.sps, 2 * self.sps),
                           dtype=self.dtype, device=dev)

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
        f = buf.reshape(buf.shape[0], -1, 2)
        if f.dtype != torch.float32:
            f = f.to(torch.float32)
        if self._int8:
            f = f * scale[:, None, None]
        return torch.view_as_complex(f)

    def _pairs_c(self, x: torch.Tensor) -> torch.Tensor:
        """(C, t) complex chunk -> (C, t, 2) wire-scale pairs."""
        return torch.view_as_real(x).to(self._wire)

    def _with_pend(self, pend, x, ilv: bool) -> torch.Tensor:
        """The sub-row carry, then the feed x, as wire-scale pairs."""
        if not ilv:
            x = self._pairs_c(x)
        elif x.dtype != pend.dtype:
            x = x.to(pend.dtype)
        return torch.cat([pend, x], dim=1)

    def _append(self, buf, x, lo: int, hi: int, ilv: bool, row: int, scale):
        """Write samples [lo, hi) of the feed x (complex, or pairs when
        `ilv`; hi - lo a multiple of 40) as rows of buf from `row` on.
        The caller appends only what fits."""
        chunk = x[:, lo:hi]
        if not ilv:
            chunk = torch.view_as_real(chunk)
        rows = self._conv(chunk, scale).reshape(x.shape[0], -1, 2 * self.sps)
        if row + rows.shape[1] > buf.shape[1]:
            raise RuntimeError(
                f"append of {rows.shape[1]} rows at row {row} overruns the "
                f"{buf.shape[1]}-row window")
        buf[:, row:row + rows.shape[1]] = rows

    def _tail(self, x, lo: int, ilv: bool) -> torch.Tensor:
        """Samples lo.. of the feed x as a wire-scale pairs copy (on the
        CPU the feed may be a view of the caller's array)."""
        tail = x[:, lo:] if ilv else self._pairs_c(x[:, lo:])
        return tail.to(self._wire, copy=True)

    def _row_of(self, pend) -> torch.Tensor:
        """The sub-row carry zero-padded to one full row of pairs."""
        return F.pad(pend, (0, 0, 0, self.sps - pend.shape[1]))

    def _slide(self, buf) -> torch.Tensor:
        """Drop the advance's rows from the window head; zero the tail (a
        new buffer, as overlapping in-place row moves are undefined)."""
        adv = self.advance // self.sps
        pad = torch.zeros((buf.shape[0], adv, 2 * self.sps),
                          dtype=buf.dtype, device=buf.device)
        return torch.cat([buf[:, adv:], pad], dim=1)

    def _chain_p0(self, p0, wrap, p0w):
        """The previous block's p0 output moved to this block's window,
        a drift-wrapped channel's taken from the host's p0w."""
        if wrap is not None:
            p0 = torch.where(wrap, p0w, p0)
        return p0 % self.spf

    def _steady(self, buf, p0, foff, scale, frac, n_frames: int):
        return rx_locked_steady(buf, p0, foff, n_frames,
                                scale=scale if self._int8 else None,
                                frac=frac)

    def _reacquire(self, buf, p0, foff, keep, scale, frac):
        x = self._cplx(buf, scale)
        if self.hunt_stride > 1:
            # the strided hunt's body decodes the rebuilt complex samples,
            # so an int8 engine's re-acquire block runs float32 K3
            return rx_locked_reacquire_strided(x, p0, foff, keep,
                                               self.block_frames, frac,
                                               self.hunt_stride)
        return rx_locked_reacquire(x, p0, foff, keep, self.block_frames,
                                   frac_old=frac)

    def _retime(self, buf, p0, foff, scale):
        return rx_locked_retime(self._cplx(buf, scale), p0, foff,
                                n_frames=self.block_frames)

    # int8 AGC: level statistics and the step change

    # (the power of a feed is summed in float64 and rounded once, so a
    # channel's statistics do not depend on how many channels share the
    # call: the reductions split their work by shape, on the card and on
    # the host's threads)

    def _stat_p(self, ss, mx, x):        # (C, t, 2) pairs
        xf = x.to(torch.float32)
        power = (xf * xf).sum(dim=(1, 2), dtype=torch.float64)
        return (ss + power.to(torch.float32),
                torch.maximum(mx, xf.abs().amax(dim=(1, 2))))

    def _stat_c(self, ss, mx, x):        # (C, t) complex
        r = x.real.to(torch.float32)
        i = x.imag.to(torch.float32)
        power = (r * r + i * i).sum(dim=1, dtype=torch.float64)
        return (ss + power.to(torch.float32),
                torch.maximum(mx, torch.maximum(r.abs().amax(dim=1),
                                                i.abs().amax(dim=1))))

    @staticmethod
    def _requant(buf, factor):
        """int8 rows at a new step: round(buf x old/new), half to even,
        clipped to +-127, as a new tensor (a retained window is never
        written)."""
        q = torch.round(buf.to(torch.float32) * factor[:, None, None])
        return torch.clamp(q, -127, 127).to(torch.int8)

    def _reset_stats(self):
        self._stat_ss = self._put(np.zeros(self.channels, np.float32))
        self._stat_max = self._put(np.zeros(self.channels, np.float32))
        self._stat_cnt = 0               # components accumulated (host)
        self._stat_gen += 1
        self._stat_snap = None

    def _snap_stats(self):
        """Queue copies of the level statistics to the host ahead of a
        block launch (CUDA, AGC only), tagged with what they hold (reset
        generation, components): an AGC update in that block's resolve
        reads them behind their own event instead of waiting for the
        block.  This is the JAX engine's fetch of the statistics with the
        block's results, taken before the block instead of after it."""
        key = (self._stat_gen, self._stat_cnt)
        if (not self._agc or self.device.type != "cuda"
                or (self._stat_snap is not None
                    and self._stat_snap[0] == key)):
            return
        self._stat_snap = (key, self._fetch(
            dict(ss=self._stat_ss, mx=self._stat_max), ("ss", "mx")))

    def _fetch(self, dev: dict, keys=_FETCHED) -> _Fetch:
        return _Fetch(dev, keys, self._join if self.mesh is not None
                      else None)

    # ------------------------------------------------------------------ #

    def feed(self, samples):
        """samples: (C, n) complex (cast to complex64) OR (C, n, 2) IQ
        pairs (float32, int16 wire format or bfloat16; cast to the buffer
        dtype during the append); numpy or tensor, copied to the engine's
        device.  Any n is accepted; appends are row-aligned (40 samples),
        so a sub-row tail pends until the next feed/flush.  Returns decoded
        frame tuples for every full window completed by this feed (and, in
        eager mode, for every block whose owned slots it completed)."""
        x, ilv = self._ingest(samples)
        if self._pend is not None:
            # sub-row carry from the previous feed: unify in the pairs
            # domain (rare — only non-40-aligned feeds reach here)
            x, ilv = self._with_pend(self._pend, x, ilv), True
            self._pend = None
        if self._agc and x.shape[1]:
            # per-channel level statistics on the device (a sub-row tail is
            # counted on the feed it arrives with; its re-count when it is
            # prepended above is noise at AGC scale)
            acc = self._stat_p if ilv else self._stat_c
            self._stat_ss, self._stat_max = acc(self._stat_ss,
                                                self._stat_max, x)
            self._stat_cnt += 2 * x.shape[1]
            if not self._agc_primed:
                # first feed: adopt the measured step before anything is
                # quantized (one synchronous fetch at stream start), so a
                # weak or deep-low-SNR stream never writes its first window
                # at the wrong step
                self._agc_primed = True
                self._agc_update(force=True)
        out = []
        off = 0
        n = x.shape[1]
        while off < n:
            room = self.window - self._count        # always row-aligned
            take = min(room, n - off)
            if take < room:
                take -= take % self.sps             # sub-row tail pends
            if take:
                self._append(self._buf, x, off, off + take, ilv,
                             self._count // self.sps, self._scale)
                self._count += take
                off += take
            if self._count >= self.window:
                out.extend(self._process())
            elif take == 0:
                break
        if off < n:
            self._pend = self._tail(x, off, ilv)
        out.extend(self._eager_poll())
        return out

    def _ingest(self, samples):
        """A feed on the engine's device(s): (x, interleaved).  A mesh
        engine splits a whole-bank feed over its shards, or takes a list of
        per-shard pieces as they are (each moved to its shard's device if
        it is not there)."""
        if self.mesh is not None and isinstance(samples, (list, tuple)):
            if len(samples) != len(self._spans):
                raise ValueError(f"expected {len(self._spans)} shard pieces")
            ilv = samples[0].ndim == 3
            parts = []
            for piece, (lo, hi), d in zip(samples, self._spans,
                                          self._devices):
                if piece.shape[0] != hi - lo:
                    raise ValueError(f"a piece of {piece.shape[0]} channels "
                                     f"for the shard of {hi - lo}")
                t = torch.as_tensor(piece)
                parts.append(to_device(t if ilv else t.to(torch.complex64),
                                       d))
            return _Shards(parts), ilv
        if samples.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        ilv = samples.ndim == 3
        x = torch.as_tensor(samples)
        x = x if ilv else x.to(torch.complex64)
        if self.mesh is None:
            return self._to_device(x), ilv
        return _Shards([to_device(x[lo:hi], d) for (lo, hi), d
                        in zip(self._spans, self._devices)]), ilv

    def flush(self):
        """Process the buffered tail (zero-padded); frames whose payload
        would extend into the padding are rejected, not emitted corrupt.
        Pipeline mode first drains the block in flight (its results come
        before the tail's)."""
        drained = self._resolve_pending() if self.pipeline else []
        if self._pend is not None:       # zero-pad the sub-row carry in
            p = self._pend.shape[1]
            self._append(self._buf, self._row_of(self._pend), 0, self.sps,
                         True, self._count // self.sps, self._scale)
            self._count += p
            self._pend = None
        min_n = self.spf + CONFIG.samples_per_symbol
        if self._count < min_n:
            results = []
        else:
            results = self._process(valid_limit=self._count)
        self._abs_base += self._count
        self._count = 0
        self._buf = self._zeros(self._where)
        return drained + results

    # ------------------------------------------------------------------ #

    def _process(self, valid_limit: int | None = None, eager: bool = False):
        if self.pipeline and valid_limit is None:
            return self._process_pipelined()
        out, wrap, p0w, tag = self._run_block(self._buf)
        results = self._resolve_block(out, self._buf, valid_limit, wrap,
                                      p0w, tag, self._abs_base,
                                      own_end=self.advance if eager
                                      else None)
        if valid_limit is None or eager:
            self._advance_window()
        return results

    def _eager_poll(self):
        """Eager mode: process pure-steady blocks as soon as their owned
        slots' samples are buffered (see __init__).  Called after every
        feed; returns the frames emitted early."""
        out = []
        while (self._eager and self._count < self.window
               and self._agc_primed and self.locked.size
               and self.locked.all() and (self.miss == 0).all()
               and not self.refresh.any()):
            need = int(self.p0.max()) + self.advance + self.sps
            need = -(-need // self.sps) * self.sps        # row-aligned
            if self._count < need:
                break
            out.extend(self._process(valid_limit=self._count, eager=True))
        return out

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

        self._snap_stats()
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
        return self._fetch(out), wrap, p0_wrapped, tag

    def _resolve_block(self, out, buf, valid_limit, wrap, p0_wrapped, tag,
                       base, own_end=None):
        """Wait for one block's results (a _Fetch) and run the host sync
        lifecycle.  own_end: block-ownership end override (an eager
        partial-window block owns the normal advance span while
        valid_limit marks the filled extent)."""
        t_res = time.monotonic() if self.timing else None
        self._fetch_ms = 0.0
        if tag == "reacquire":
            self.reacquisitions += 1
        self._want_refresh[:] = False
        prev_locked = self.locked.copy()
        results = self._emit(out, valid_limit, base, own_extra=wrap,
                             own_end=own_end)
        self.p0 = np.where(wrap, p0_wrapped, self.p0).astype(np.int32)

        # a channel that dropped lock during this block is re-hunted over
        # THIS window (the reference goes LOCKED -> HUNTING at the drop
        # sample and scans on, src/opv-demod.cpp:695-713), so a burst
        # starting later in the same window keeps its first frame
        dropped = prev_locked & ~self.locked
        if dropped.any():
            self.reacquisitions += 1
            self._snap_stats()
            out2 = self._reacquire(buf, self._put_state("p0", self.p0),
                                   self._put_state("foff", self.freq_offset),
                                   self._put_state("keep", ~dropped),
                                   self._scale,
                                   self._put_state("frac", self.frac))
            results.extend(self._emit(self._fetch(out2), valid_limit, base,
                                      only=dropped, min_pos=self._dropped_at,
                                      own_end=own_end))
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
        self._blocks += 1
        # AGC cadence, plus every lock transition: a lock loss is often a
        # level change (a burst on a quiet channel, a fade), and the re-hunt
        # succeeds only once the window is quantized at the new step.  The
        # transition, not the unlocked state, triggers it, so a bank with
        # idle channels still updates at the cadence only.
        if self._agc and (self._blocks % self._AGC_BLOCKS == 0
                          or dropped.any()
                          or (~prev_locked & self.locked).any()):
            self._agc_update()
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
        # the slide builds a new buffer, so a window retained by a block in
        # flight (pipeline mode) is never written
        self._buf = self._slide(self._buf)
        self._count -= self.advance
        self._abs_base += self.advance
        # grid positions repeat every frame, so after advancing by an exact
        # frame multiple the same sync sits at p0 mod 86,720
        self.p0 = self.p0 % self.spf

    def _agc_update(self, force: bool = False):
        """Re-evaluate the int8 step from the level statistics; adopt per
        channel where the desired step left the hysteresis band, and
        re-quantize the buffered window so its rows and the next share one
        step.  force=True (first feed) adopts any change: the first window
        must be written at the measured step, not the wire-full-scale
        default."""
        if not self._agc or self._stat_cnt == 0:
            return
        # the statistics copied ahead of the last launch, if nothing was
        # fed or reset since; else one synchronous fetch of both vectors
        snap = self._stat_snap
        if snap is not None and snap[0] == (self._stat_gen, self._stat_cnt):
            host = snap[1].wait()
            ss, mx = host["ss"], host["mx"]
        else:
            ss, mx = self._get((self._stat_ss, self._stat_max))
        rms = np.sqrt(ss / self._stat_cnt)
        desired = np.minimum(mx, self._AGC_SIGMA * rms) * (1.0 / 127.0)
        desired = np.maximum(desired, 1e-6).astype(np.float32)  # silence
        ratio = desired / self._scale_np
        adopt = (ratio > self._AGC_BAND) | (ratio < 1.0 / self._AGC_BAND)
        if force:
            adopt = adopt | (ratio != 1.0)
        if adopt.any():
            new = np.where(adopt, desired, self._scale_np).astype(np.float32)
            if self._count:              # re-quantize the buffered window
                factor = (self._scale_np / new).astype(np.float32)
                self._buf = self._requant(self._buf, self._put(factor))
            self._scale_np = new
            self._scale = self._put(new)
        self._reset_stats()

    def _process_pipelined(self):
        """One full window in pipeline mode: launch this block with the
        last resolved state (predicted), then resolve the previous block,
        whose fetch and lifecycle overlap this block on the card.  A wrong
        prediction (a lock change, or a timing refresh due) launches this
        block again on its retained window with the exact state."""
        if self._pending is None:
            # first window: the host state is exact, launch directly
            out, wrap, p0w, tag = self._run_block(self._buf)
            self._pending = dict(out=out, buf=self._buf, wrap=wrap, p0w=p0w,
                                 tag=tag, base=self._abs_base)
            self._advance_window()
            return []

        prev = self._pending
        pred_locked = self.locked.copy()
        retune_pred = self.refresh & self.locked
        launched = None
        if not retune_pred.any():
            launched = self._launch_predicted(prev, pred_locked)
        # resolve the previous block (its fetch overlaps the launched block)
        results = self._resolve_block(prev["out"], prev["buf"], None,
                                      prev["wrap"], prev["p0w"], prev["tag"],
                                      prev["base"])
        self.p0 = self.p0 % self.spf     # previous -> current window coords
        retune_actual = self.refresh & self.locked
        if (launched is None or retune_actual.any()
                or not np.array_equal(self.locked, pred_locked)):
            # prediction invalid: launch this window again with exact state
            launched = self._run_block(self._buf)
        out, wrap, p0w, tag = launched
        self._pending = dict(out=out, buf=self._buf, wrap=wrap, p0w=p0w,
                             tag=tag, base=self._abs_base)
        self._advance_window()
        return results

    def _launch_predicted(self, prev, pred_locked):
        """Launch the current window's program on the predicted state:
        p0, freq_offset and frac chain on the device from the previous
        block's unfetched outputs (a wrap block's wrapped channels take the
        host-computed p0_wrapped), the program from the last resolved lock
        state.  Queues work only: nothing here waits for the device."""
        dev = prev["out"].dev
        wrapped = prev["wrap"].any()
        p0_dev = self._chain_p0(dev["p0"],
                                self._put(prev["wrap"]) if wrapped else None,
                                self._put(prev["p0w"]) if wrapped else None)
        foff_dev, frac_dev = dev["freq_offset"], dev["frac"]
        self._snap_stats()
        if pred_locked.all():
            o = self._steady(self._buf, p0_dev, foff_dev, self._scale,
                             frac_dev, self.block_frames)
            tag = "steady"
        else:
            o = self._reacquire(self._buf, p0_dev, foff_dev,
                                self._put(pred_locked), self._scale,
                                frac_dev)
            tag = "reacquire"
        return self._fetch(o), np.zeros(self.channels, bool), self.p0, tag

    def _resolve_pending(self):
        """Drain the block in flight (pipeline mode): resolve it and return
        its tuples.  Afterwards the host state is the synchronous engine's."""
        if self._pending is None:
            return []
        prev, self._pending = self._pending, None
        results = self._resolve_block(prev["out"], prev["buf"], None,
                                      prev["wrap"], prev["p0w"], prev["tag"],
                                      prev["base"])
        self.p0 = self.p0 % self.spf
        return results

    def _emit(self, out, valid_limit, base, only=None, min_pos=None,
              own_extra=None, own_end=None):
        """Run the host-side sync lifecycle over one block result (a
        _Fetch).

        only: bool (C,) — process just these channels (re-hunt second pass).
        min_pos: int (C,) — reject frames before this window position (the
        slot where lock was dropped).
        own_extra: bool (C,) — extend this channel's block ownership by one
        frame (drift-wrap straddler, see _run_block).
        base: absolute stream index of this block's window start.
        own_end: where this block's ownership ends (default: the advance,
        or the valid limit of a flushed tail)."""
        t_fetch = time.monotonic() if self.timing else None
        out = out.wait()
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
        if own_end is None:
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
        and layouts): buf and pend are tensors on the device (copies; a
        mesh engine's shards joined on its first device), the rest numpy.
        Raises while a pipelined block is in flight."""
        if self._pending is not None:
            raise RuntimeError(
                "pipelined stream has a block in flight; checkpoint at a "
                "flush boundary (call flush() first) or use the synchronous "
                "engine for checkpointed streams")
        # pend is stored zero-padded to one full row + its true length so
        # the leaf shapes are feed-history independent; it lives at WIRE
        # scale (float32 for int8 buffers)
        pend = torch.zeros((self.channels, self.sps, 2), dtype=self._wire,
                           device=self.device)
        pend_len = 0
        if self._pend is not None:
            pend_len = self._pend.shape[1]
            pend = self._full(self._row_of(self._pend))
        return dict(
            buf=self._full(self._buf), count=np.int64(self._count),
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
        complex (pre-wire-form checkpoints), in any buffer dtype, written
        by an engine with or without a mesh (a mesh engine converts on the
        host, then splits)."""
        dev = self.device if self.mesh is None else torch.device("cpu")
        buf = torch.as_tensor(tree["buf"]).to(dev)
        # the checkpoint's quantization step (per channel); pre-AGC
        # checkpoints carry no scale field — their int8 buffers are at the
        # fixed wire-full-scale step
        tree_scale = np.asarray(
            tree.get("scale", np.full(self.channels, INT8_SCALE)),
            np.float32)
        scale = torch.tensor(tree_scale).to(dev)
        if buf.dim() == 2:
            buf = torch.view_as_real(buf).to(torch.float32)
        if buf.shape[-1] == 2:           # pairs -> window rows
            buf = buf.reshape(self.channels, -1, 2 * self.sps)
        # cross-dtype adoption: int8 buffers hold wire/scale values, float
        # buffers hold wire-scale values — rescale across the domains
        if buf.dtype == torch.int8 and not self._int8:
            buf = buf.to(torch.float32) * scale[:, None, None]
        if self._int8:
            self._scale_np = tree_scale.copy()
            self._scale = self._put(self._scale_np)
        if self._int8 and buf.dtype != torch.int8:
            # wire-scale floats -> quantized at the adopted step
            buf = self._conv(buf, scale).contiguous()
        else:
            buf = buf.to(self.dtype, copy=True).contiguous()
        count = int(tree["count"])
        pend = None
        rem = count % self.sps
        if rem:
            # pre-windowed checkpoints could hold a sub-row count; move the
            # partial row's samples to the pend carry (the next append
            # rewrites that row with pend + new data — identical values)
            pairs = buf.reshape(self.channels, -1, 2)
            pend = pairs[:, count - rem:count].to(self._wire, copy=True)
            if self._int8:               # buffer domain -> wire scale
                pend = pend * scale[:, None, None]
            count -= rem
        self._count = count
        if "pend" in tree and int(tree.get("pend_len", 0)):
            p = int(tree["pend_len"])
            assert pend is None          # aligned count when pend was saved
            pend = torch.as_tensor(tree["pend"]).to(dev)[:, :p].to(
                self._wire, copy=True)
        self._buf = self._place(buf)
        self._pend = None if pend is None else self._place(pend)
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
        # the restored step is authoritative: no priming off the next feed,
        # and the statistics start afresh
        if self._agc:
            self._agc_primed = True
            self._reset_stats()
