"""Feeds of tests/test_locked_stream.py's scenarios, shared by the port's
engine tests (tests/test_torch_stream*.py): the same input goes through
the JAX package's LockedStreamDemodulator and the port's, and their tuple
streams must agree.  Every feed is made from a fixed seed with numpy."""

import numpy as np
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.tx import modulate_frames, tx_flush_zeros

SPF = CONFIG.samples_per_frame
#: tuple streams: channel, bytes, metric and position equal; sync quality
#: within this (float32 sums taken in another order)
Q_TOL = 1e-4


def signal(n_frames, call="W5NYV", start=0):
    """(N,) complex64 BERT transmission through the JAX package's TX, and
    its frames."""
    frames = build_bert_frame(call, frame_num=start + np.arange(n_frames))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64), np.asarray(frames)


def run(sd, x, chunk=None):
    """Feed x whole (or in chunks), then flush; all emitted tuples."""
    out = []
    if chunk is None:
        out.extend(sd.feed(x))
    else:
        for off in range(0, x.shape[1], chunk):
            out.extend(sd.feed(x[:, off:off + chunk]))
    out.extend(sd.flush())
    return out


def assert_same_stream(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert (g[0], g[1], g[2], g[4]) == (w[0], w[1], w[2], w[4]), \
            ((g[0], g[2], g[4]), (w[0], w[2], w[4]))
        assert abs(g[3] - w[3]) <= Q_TOL, (g[3], w[3])


def gap_burst(seed=1, n1=6, n2=6, gap_frames=8, cfo=500.0, shift=23):
    """Burst 1, a noise gap long enough to drop lock, burst 2 at another
    sample phase (+shift) and +cfo Hz: (N,) complex64 and the frames."""
    rng = np.random.default_rng(seed)
    s1, f1 = signal(n1)
    s2, f2 = signal(n2, start=100)
    gap = (rng.standard_normal(gap_frames * SPF) +
           1j * rng.standard_normal(gap_frames * SPF)).astype(np.complex64) * 50.0
    t = np.arange(len(s2))
    s2 = (s2 * np.exp(2j * np.pi * cfo * t / CONFIG.sample_rate)
          ).astype(np.complex64)
    s2 = np.concatenate([np.zeros(shift, np.complex64), s2])
    return np.concatenate([s1, gap, s2]), f1, f2


def drifted(n_frames, ppm=16.0):
    """A BERT transmission resampled for a +ppm sample-clock error."""
    s, frames = signal(n_frames)
    d = ppm * 1e-6
    n_out = int(len(s) / (1 + d))
    t = np.arange(n_out) * (1 + d)
    base = np.arange(len(s), dtype=np.float64)
    x = (np.interp(t, base, s.real) + 1j * np.interp(t, base, s.imag))
    return x.astype(np.complex64), frames
