"""Wideband receiver: one digitizer stream in, decoded frames from every
OPV channel out (counterpart of opv_tpu/stream/wideband.py).

The analysis channelizer (rx/channelizer.py) feeds a multichannel engine:
the locked streaming engine (stream/locked.py, engine="locked", the
default) or the feed-forward dense receiver (stream/multichannel.py,
engine="fast": dense correlation every block, no lock state, for bursty
many-transmitter channels).  Feed blocks of wideband IQ at K x 2.168
Msamples/s; get (channel, frame_bytes, metric, sync_quality,
abs_channel_sample_pos) tuples.  The filter history is carried across
feeds, so channelization is streaming-exact.

The wideband window (K*taps - 1 samples of filter history plus one
processing quantum) lives on the engine's device; so do the channelizer's
(K, M) output and the engine's window rows.  Only the digitizer's samples
go to the card and only the decoded frames come back.

Every feed goes through one append / channelize / slide loop; a steady
quantum (exactly one quantum into a primed window) is one pass of it: one
channelize call and one engine feed.  The JAX receiver gives that case a
path of its own, which fuses the channelizer with the engine's row append
into one jitted dispatch (its external-ingest API); run eagerly, the
fusion would be channelize, then feed(), which is what the loop does.

mesh= (engine="locked"): the engine splits the K channels over the mesh's
'ch' axis (stream/locked.py) and the wideband window is replicated once on
each distinct device of this process's shards, appended and slid alike on
each.  Each device filters the polyphase legs once; each 'ch' shard
applies only its own channels' columns of dft_kernel(k)
(rx/channelizer.py::dft_columns) and feeds its piece to its engine shard,
so no channel data crosses devices: the sample path is collective-free.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.channelizer import (channelize, dft_columns,
                                          dft_kernel, polyphase_legs)
from opv_tpu_torch.stream.locked import LockedStreamDemodulator
from opv_tpu_torch.stream.multichannel import MultiChannelDemodulator
from opv_tpu_torch.stream.state import to_device
from opv_tpu_torch.utils.spans import OFF


class WidebandReceiver:
    def __init__(self, k: int, block_frames: int = 4,
                 taps_per_branch: int = 12, engine: str = "locked",
                 quantum_out: int | None = None, pipeline: bool = False,
                 dtype: str = "auto", timing: bool = False, mesh=None,
                 hunt_stride: int = 1, device="cuda"):
        """k channels of a K x 2.168 Msamples/s stream.  block_frames goes
        to the engine; pipeline, dtype ("auto" is float32, as in the
        engine), timing and hunt_stride to the locked engine (the fast
        engine has none of them and ignores all but pipeline, which it
        refuses); device= is where the engine and the wideband window live
        ("cuda" by default, which raises without a card; "cpu" runs the
        plain twins).

        quantum_out: channel samples per channelizer call (default: the
        engine's block advance, so a steady block takes one call).  It
        must divide the advance for the steady path to repeat.

        mesh: a parallel.mesh.Mesh with a 'ch' axis, with engine="locked"
        only (it replaces device=; see the module docstring).

        With timing, the receiver's own work goes into the locked engine's
        timing records (utils/spans.py): the host spans wideband.append,
        wideband.channelize (the launch) and wideband.slide, and the
        channelizer's device span, "channelize"."""
        if engine == "locked":
            self.demod = LockedStreamDemodulator(channels=k,
                                                 block_frames=block_frames,
                                                 pipeline=pipeline,
                                                 dtype=dtype, timing=timing,
                                                 mesh=mesh,
                                                 hunt_stride=hunt_stride,
                                                 device=device)
        elif engine == "fast":
            if pipeline:
                raise ValueError("pipeline=True requires engine='locked'")
            if mesh is not None:
                raise ValueError("mesh= requires engine='locked'")
            self.demod = MultiChannelDemodulator(channels=k,
                                                 block_frames=block_frames,
                                                 device=device)
        else:
            raise ValueError("engine must be 'locked' or 'fast'")
        self.mesh = mesh
        self.device = self.demod.device
        self._rec = getattr(self.demod, "_rec", None)
        self.k = k
        self.taps = taps_per_branch
        self._hist = k * taps_per_branch - 1         # filter history
        if quantum_out is None:
            quantum_out = block_frames * CONFIG.samples_per_frame
        self._quantum = k * quantum_out              # wideband samples
        self.window = self._hist + self._quantum
        if mesh is not None:
            # each shard's columns of the DFT kernel, on its device
            table = dft_kernel(k)
            self._kerns = [
                torch.from_numpy(np.ascontiguousarray(table[:, lo:hi])).to(
                    d, torch.float32)
                for (lo, hi), d in zip(self.demod._spans,
                                       self.demod._devices)]
            devices = list(dict.fromkeys(self.demod._devices))
        else:
            devices = [self.device]
        #: the wideband window, one replica per device
        self._bufs = {d: self._zeros(d) for d in devices}
        self._count = 0                              # valid window samples

    @property
    def quantum(self) -> int:
        """Wideband samples of one steady feed."""
        return self._quantum

    def _zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.window, dtype=torch.complex64, device=device)

    def _put(self, wideband) -> torch.Tensor:
        """(n,) complex (numpy or tensor) -> complex64; on the device (a
        host array through the engine's pinned staging), or left where it
        is for a mesh receiver, which copies each append to its replicas."""
        if isinstance(wideband, torch.Tensor):
            x = wideband.to(torch.complex64)
        else:
            x = torch.from_numpy(np.asarray(wideband, np.complex64))
        return x if self.mesh is not None else self.demod._to_device(x)

    def _slide(self) -> None:
        """Keep the filter history at the front of a new window (a new
        buffer, zero beyond it), on every replica."""
        for d, old in self._bufs.items():
            buf = self._zeros(d)
            buf[: self._hist] = old[self._quantum:]
            self._bufs[d] = buf

    def _channels(self, n: int):
        """The channels of the window's first n samples for the engine: a
        (K, M) tensor, or a mesh engine's per-shard pieces (the polyphase
        legs filtered once per device, each shard's DFT columns on its
        device)."""
        if self.mesh is None:
            return channelize(self._bufs[self.device][:n], self.k, self.taps)
        legs = {d: polyphase_legs(b[:n], self.k, self.taps)
                for d, b in self._bufs.items()}
        return [dft_columns(legs[d], kern, self.k)
                for d, kern in zip(self.demod._devices, self._kerns)]

    def feed(self, wideband):
        """wideband: (n,) complex at K*fs_ch, numpy or tensor, cast to
        complex64.  Returns decoded-frame tuples (channel, frame_bytes,
        metric, sync_quality, abs_sample_pos), positions in channel-rate
        samples."""
        rec = self._rec
        with rec.span("wideband.append") if rec else OFF:
            x = self._put(wideband)
        n = x.shape[0]
        out = []
        off = 0
        while off < n:
            take = min(self.window - self._count, n - off)
            with rec.span("wideband.append") if rec else OFF:
                for d, buf in self._bufs.items():
                    buf[self._count:self._count + take] = to_device(
                        x[off:off + take], d)
            self._count += take
            off += take
            if self._count >= self.window:
                with rec.span("wideband.channelize") if rec else OFF, \
                        rec.pair("channelize", self.device) if rec else OFF:
                    chans = self._channels(self.window)
                out.extend(self.demod.feed(chans))
                with rec.span("wideband.slide") if rec else OFF:
                    self._slide()
                self._count = self._hist
        return out

    def flush(self):
        """Channelize the buffered tail (whole output samples only), then
        flush the engine."""
        h = self._hist
        results = []
        if self._count >= h + self.k:
            usable = h + ((self._count - h) // self.k) * self.k
            results.extend(self.demod.feed(self._channels(usable)))
        self._bufs = {d: self._zeros(d) for d in self._bufs}
        self._count = 0
        results.extend(self.demod.flush())
        return results

    # ------------------------------------------------------------------ #
    # checkpoint/resume (stream/state.py): the filter-history window plus
    # the engine's state, in the JAX package's layout, so checkpoints cross
    # between the packages both ways

    def state_tree(self) -> dict:
        """{buf: the (window,) complex64 wideband window (a copy on the
        device), count, demod: the engine's state_tree()}.  Raises while a
        pipelined block is in flight, and with engine='fast'."""
        if not isinstance(self.demod, LockedStreamDemodulator):
            raise RuntimeError(
                "wideband checkpointing requires engine='locked' (the "
                "'fast' engine carries no stream state worth saving)")
        buf = next(iter(self._bufs.values())).clone()
        return dict(buf=buf, count=np.int64(self._count),
                    demod=self.demod.state_tree())

    def load_state_tree(self, tree) -> None:
        """Adopt a state_tree() of either package (e.g. via load_state)."""
        buf = tree["buf"]
        buf = (buf if isinstance(buf, torch.Tensor)
               else torch.from_numpy(np.asarray(buf, np.complex64)))
        if tuple(buf.shape) != (self.window,):
            raise ValueError(
                f"checkpoint window {tuple(buf.shape)} does not match this "
                f"receiver's geometry ({self.window},): same k, "
                f"taps_per_branch and quantum required")
        self._bufs = {d: buf.to(d, torch.complex64, copy=True)
                      for d in self._bufs}
        self._count = int(tree["count"])
        self.demod.load_state_tree(tree["demod"])

    def stats(self) -> dict:
        """The locked engine's per-block timing and lifecycle stats
        (timing=True): device wait against host lifecycle per resolved
        block; {} with engine='fast'."""
        fn = getattr(self.demod, "stats", None)
        return fn() if fn is not None else {}

    @property
    def decoded(self) -> int:
        return self.demod.decoded

    @property
    def perfect(self) -> int:
        return self.demod.perfect
