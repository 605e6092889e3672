"""Sharded streaming (counterpart of opv_tpu/stream/sharded.py):
rx_grid_sharded over successive windows of an unbounded (C, n) stream.

The demodulator keeps a rolling window of ntime * shard_samples samples split
over the mesh's (ch, time) grid:

  * each step decodes the window (intra-window seams go through the halo
    exchange of parallel/sharded.py);
  * the window then slides by `window - HALO_SAMPLES`, so the retained
    tail (one full frame and a sync word of lookback) is decoded again at
    the head of the next window: a frame straddling the window seam
    decodes there;
  * cross-window ownership is exact: a frame whose sync word starts at
    absolute sample s fits a window ending at absolute sample e iff
    s + samples_per_frame <= e, so it is emitted by the first window it
    fits and skipped by later ones (s + samples_per_frame <= the previous
    window's end).

The window buffer is born sharded: one (C/nch, shard_samples) complex64
block per (ch, time) shard of this process, on the shard's device, never
gathered.  Appends, the slide and the flush's zero tail run per block;
only decoded frames and per-frame scalars come back, in one packed fetch
per window.  state_tree() holds the window as one (C, window) tensor in
the JAX package's layout, so a checkpoint of either package resumes in
the other, on any geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.parallel.grid import rx_grid_sharded
from opv_tpu_torch.parallel.mesh import process_rank
from opv_tpu_torch.parallel.multihost import all_gather
from opv_tpu_torch.parallel.sharded import HALO_SAMPLES, layout
from opv_tpu_torch.stream.multichannel import _pack, _unpack


class ShardedStreamDemodulator:
    """Feed (C, n) complex sample blocks; yields (channel, frame_bytes,
    metric, sync_quality, abs_sample_pos) tuples (the contract of
    LockedStreamDemodulator), each frame exactly once, also when it
    straddles a window seam on any shard.

    mesh must carry axes 'ch' and 'time'; channels must divide by the 'ch'
    axis size.  shard_samples is the window's slice per time shard
    (default: the smallest legal, the halo rounded up to 128 samples).
    kw goes to rx_fast (e.g. estimate_cfo_flag)."""

    def __init__(self, mesh, channels: int, shard_samples: int | None = None,
                 max_frames_per_shard: int = 8, **kw):
        self.mesh = mesh
        self.channels = channels
        nch = mesh.shape["ch"]
        ntime = mesh.shape["time"]
        if channels % nch:
            raise ValueError(f"{channels} channels not divisible by "
                             f"ch-axis size {nch}")
        if shard_samples is None:
            shard_samples = -(-HALO_SAMPLES // 128) * 128
        if shard_samples < HALO_SAMPLES:
            raise ValueError(f"shard_samples {shard_samples} < halo "
                             f"{HALO_SAMPLES}; seam frames would vanish")
        self.shard_samples = shard_samples
        self.window = ntime * shard_samples
        self.advance = self.window - HALO_SAMPLES
        spf = CONFIG.samples_per_frame
        if self.advance < spf:
            raise ValueError(
                f"window {self.window} advances by {self.advance} < one "
                f"frame ({spf}); a sync landing on the last sample of a "
                f"window could never fit the next: grow shard_samples or "
                f"the time axis")
        self.max_frames_per_shard = max_frames_per_shard
        self._kw = kw
        devs, ranks = layout(mesh, ("ch", "time"))
        self._lc = channels // nch
        me = process_rank()
        #: this process's blocks: (i, j) -> device
        self._where = {(i, j): devs[i, j] for i in range(nch)
                       for j in range(ntime) if ranks[i, j] == me}
        self._ranks = ranks
        self._buf = self._zeros()
        self._count = 0          # valid samples in the window
        self._abs_base = 0       # absolute stream index of window sample 0
        self._prev_end = 0       # absolute end of the last decoded window
        self.decoded = 0
        self.perfect = 0

    # -- the sharded window ---------------------------------------------- #

    def _zeros(self) -> dict:
        return {k: torch.zeros((self._lc, self.shard_samples),
                               dtype=torch.complex64, device=d)
                for k, d in self._where.items()}

    def _append(self, at: int, x: torch.Tensor) -> None:
        """Write the (C, t) chunk x at window position `at`: each block
        takes its channels' part of the chunk's overlap with its span."""
        s, lc = self.shard_samples, self._lc
        for (i, j), blk in self._buf.items():
            a, b = max(at, j * s), min(at + x.shape[1], (j + 1) * s)
            if a < b:
                blk[:, a - j * s:b - j * s] = \
                    x[i * lc:(i + 1) * lc, a - at:b - at].to(blk.device)

    def _slide(self) -> None:
        """Drop the advance from the window head into new blocks: block j
        takes window samples [j*S + advance, (j+1)*S + advance) of the old
        window, zeros beyond its end.  A piece held by another process
        crosses over gloo (every process joins that gather)."""
        s, adv = self.shard_samples, self.advance
        nch, ntime = self._ranks.shape
        moves = []          # (source block, src lo, src hi, dst block, at)
        for i in range(nch):
            for j in range(ntime):
                for jj in range(ntime):
                    a = max(j * s + adv, jj * s)
                    b = min((j + 1) * s + adv, (jj + 1) * s)
                    if a < b:
                        moves.append(((i, jj), a - jj * s, b - jj * s,
                                      (i, j), a - j * s - adv))
        remote = {}
        if any(self._ranks[src] != self._ranks[dst]
               for src, _, _, dst, _ in moves):
            mine = {(src, lo, hi): self._buf[src][:, lo:hi].cpu()
                    for src, lo, hi, dst, _ in moves
                    if src in self._buf and dst not in self._buf}
            for part in all_gather(mine):
                remote.update(part)
        new = self._zeros()
        for src, lo, hi, dst, at in moves:
            if dst in new:
                piece = (self._buf[src][:, lo:hi] if src in self._buf
                         else remote[(src, lo, hi)])
                new[dst][:, at:at + hi - lo] = piece.to(new[dst].device)
        self._buf = new

    def _zero_tail(self, count: int) -> None:
        """Blank every window sample from `count` on (the flush)."""
        s = self.shard_samples
        for (_, j), blk in self._buf.items():
            blk[:, max(count - j * s, 0):] = 0

    # ------------------------------------------------------------------ #

    def feed(self, samples):
        """samples: (C, n) complex, numpy or tensor (cast to complex64).
        Returns decoded frame tuples for every full window this feed
        completed."""
        x = (samples if isinstance(samples, torch.Tensor)
             else torch.from_numpy(np.asarray(samples)))
        if x.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels")
        x = x.to(torch.complex64)
        out = []
        off = 0
        n = x.shape[1]
        while off < n:
            take = min(self.window - self._count, n - off)
            self._append(self._count, x[:, off:off + take])
            self._count += take
            off += take
            if self._count >= self.window:
                out.extend(self._process())
        return out

    def flush(self):
        """Decode the buffered tail (zero-padded to the window); only frames
        wholly inside the valid samples are emitted."""
        if self._count == 0:
            return []
        self._zero_tail(self._count)
        results = self._process(valid_limit=self._count)
        self._abs_base += self._count
        self._count = 0
        self._buf = self._zeros()
        return results

    def _process(self, valid_limit: int | None = None):
        out = rx_grid_sharded(self.mesh, self._buf,
                              max_frames_per_shard=self.max_frames_per_shard,
                              **self._kw)
        # one transfer for the whole result: frames and per-frame scalars
        # packed into one uint8 tensor
        frames, starts, metrics, q, owned = _unpack(
            _pack(dict(out, frame_valid=out["owned"])).cpu().numpy())
        spf = CONFIG.samples_per_frame
        vlim = self.window if valid_limit is None else valid_limit
        valid_end = self._abs_base + vlim
        results = []
        for c in range(self.channels):
            for k in np.nonzero(owned[c])[0]:
                s_abs = self._abs_base + int(starts[c, k])
                if s_abs + spf <= self._prev_end:
                    continue            # emitted by an earlier window
                if s_abs + spf > valid_end:
                    continue            # tail frame: incomplete samples
                self.decoded += 1
                if metrics[c, k] == 0:
                    self.perfect += 1
                results.append((c, bytes(frames[c, k]), int(metrics[c, k]),
                                float(q[c, k]), s_abs))
        self._prev_end = valid_end
        if valid_limit is None:
            self._slide()
            self._count = self.window - self.advance
            self._abs_base += self.advance
        return results

    # -- checkpoint/resume (stream/state.py) ------------------------------ #

    def state_tree(self) -> dict:
        """{buf: the (C, window) complex64 window on the host (the blocks of
        every process gathered), count, abs_base, prev_end, decoded,
        perfect}: the JAX package's keys and layout."""
        local = {k: b.cpu() for k, b in self._buf.items()}
        parts = {}
        for part in (all_gather(local) if self.mesh.multiprocess
                     else [local]):
            parts.update(part)
        nch, ntime = self._ranks.shape
        buf = torch.cat([torch.cat([parts[(i, j)] for j in range(ntime)],
                                   dim=1) for i in range(nch)])
        return dict(
            buf=buf, count=np.int64(self._count),
            abs_base=np.int64(self._abs_base),
            prev_end=np.int64(self._prev_end),
            decoded=np.int64(self.decoded), perfect=np.int64(self.perfect))

    def load_state_tree(self, tree) -> None:
        """Adopt a state_tree() of either package (e.g. via load_state):
        the window is split onto this demodulator's blocks, whatever geometry
        wrote it."""
        buf = tree["buf"]
        buf = (buf if isinstance(buf, torch.Tensor)
               else torch.from_numpy(np.asarray(buf, np.complex64)))
        self._buf = self._zeros()
        self._append(0, buf.to(torch.complex64))
        self._count = int(tree["count"])
        self._abs_base = int(tree["abs_base"])
        self._prev_end = int(tree["prev_end"])
        self.decoded = int(tree["decoded"])
        self.perfect = int(tree["perfect"])
