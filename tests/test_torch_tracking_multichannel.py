"""The port's MultiChannelTrackingDemodulator (opv_tpu_torch/stream/
tracking.py) on the CPU: TestTrackingParity and TestDivergentClocks of
tests/test_tracking_multichannel.py run against the port (each channel
equal to its own single-channel StreamingDemodulator), and the JAX
package's multichannel tuples on the same feed (frames, metrics and
symbol indices equal, sync quality within Q_TOL: float64 sums rounded
differently at the ~1e-15 level)."""

import numpy as np
import torch

from opv_tpu.config import CONFIG
from opv_tpu.stream.tracking import MultiChannelTrackingDemodulator as TrackJ
from opv_tpu_torch.stream import (MultiChannelTrackingDemodulator,
                                  StreamingDemodulator)

Q_TOL = 1e-12


def _load_iq(golden_dir, name):
    raw = np.fromfile(golden_dir / name, dtype="<i2").reshape(-1, 2)
    return raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)


def _mc(channels):
    return MultiChannelTrackingDemodulator(channels=channels, device="cpu")


class TestTrackingParity:
    def test_two_heterogeneous_channels(self, golden_dir):
        """Channel 0: clean bert3; channel 1: +500 Hz cfo500 — each
        channel's tuples exactly its single-channel run's, and JAX's
        multichannel tuples."""
        s0 = _load_iq(golden_dir, "bert3.iq")
        s1 = _load_iq(golden_dir, "cfo500.iq")
        n = min(len(s0), len(s1))
        chans = np.stack([s0[:n], s1[:n]])
        singles = []
        for s in chans:
            sd = StreamingDemodulator(device="cpu")
            singles.append(sd.feed(s) + sd.flush())
        mc = _mc(2)
        res = mc.feed(chans) + mc.flush()
        for c in (0, 1):
            assert [r[1:] for r in res if r[0] == c] == singles[c]
        assert mc.sync_state == ["LOCKED", "LOCKED"]
        mj = TrackJ(channels=2)
        want = mj.feed(chans) + mj.flush()
        assert [(r[0], r[1], r[2], r[4]) for r in res] == \
            [(r[0], r[1], r[2], r[4]) for r in want]
        assert max(abs(a[3] - b[3]) for a, b in zip(res, want)) <= Q_TOL
        assert np.array_equal(mc.decoded, mj.decoded)
        assert np.array_equal(mc.total_symbols, mj.total_symbols)
        assert np.array_equal(mc.est_offset, np.asarray(mj.est_offset))

    def test_slicing_invariance(self, golden_dir):
        """Ragged feeds (a CPU tensor): both channels give bert3's frames."""
        s0 = _load_iq(golden_dir, "bert3.iq")
        chans = torch.from_numpy(np.stack([s0, s0]))
        rng = np.random.default_rng(1)
        mc = _mc(2)
        res, off = [], 0
        while off < chans.shape[1]:
            k = int(rng.integers(1, 60_000))
            res += mc.feed(chans[:, off:off + k])
            off += k
        res += mc.flush()
        golden = np.frombuffer((golden_dir / "bert3.frames").read_bytes(),
                               dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
        for c in (0, 1):
            got = [np.frombuffer(fb, np.uint8) for cc, fb, m, q, i in res
                   if cc == c]
            np.testing.assert_array_equal(np.stack(got), golden)


class TestDivergentClocks:
    def test_no_deadlock_no_data_loss(self, golden_dir):
        """Channels with a 300 ppm relative clock offset: per-channel buffer
        counts drift apart indefinitely; the receiver must neither deadlock
        nor drop input, and gives JAX's tuples."""
        s = _load_iq(golden_dir, "bert3.iq")
        ppm = 300e-6
        n_out = int(len(s) / (1 + ppm)) - 2
        t = np.arange(n_out) * (1 + ppm)
        i0 = t.astype(np.int64)
        f = t - i0
        s_slow = s[i0] * (1 - f) + s[i0 + 1] * f
        n = min(len(s), len(s_slow))
        chans = np.concatenate([np.stack([s[:n], s_slow[:n]])] * 3, axis=1)
        mc = _mc(2)
        res = mc.feed(chans) + mc.flush()
        c0 = sum(1 for r in res if r[0] == 0)
        c1 = sum(1 for r in res if r[0] == 1)
        assert c0 >= 8 and c1 >= 8, (c0, c1)
        mj = TrackJ(channels=2)
        want = mj.feed(chans) + mj.flush()
        assert [(r[0], r[1], r[2], r[4]) for r in res] == \
            [(r[0], r[1], r[2], r[4]) for r in want]
