"""The port's MultiChannelDemodulator (opv_tpu_torch/stream/multichannel.py)
and WidebandReceiver(engine="fast") against the JAX package on the CPU:
the scenarios of tests/test_multichannel.py and the K = 4 signal of
tests/test_wideband.py::test_streaming_decode, with the same feeds to both
packages and the JAX tests' own assertions on the port's tuples.

Each package estimates the CFO per block on a grid whose energy curve is
flat to ~1e-6 near its peak, so the two estimates differ by up to tens of
Hz (ROADMAP queue 3).  The tests give the port's blocks the JAX package's
estimate of the same block (the pinned_cfo fixture), and hold every
block's slots to the JAX rx_fast's as tests/test_torch_fast.py does:
identical, except at a plateau tie of the MSK sync apex, where a start
may sit one sample away and its metric differ.  The tuple streams are then
identical in channel and frame bytes, with the position within one sample
(the ties above; a JAX block may break its ties otherwise inside its own
jit), the metric equal wherever the position is, and the sync quality
within Q_TOL.  On the wideband signal a quiet channel decodes
adjacent-channel leakage as garbage from small differences of large tone
energies, which float32 order (the channelizer's, the soft stage's) moves:
there the two packages agree in channel and position, both metrics exceed
100 and the sync quality agrees within GARBAGE_Q_TOL (ROADMAP queue 3)."""

import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_torch_fast import _assert_same as same_block  # noqa: E402
from test_torch_wideband import capture, ragged  # noqa: E402

from opv_tpu.config import CONFIG  # noqa: E402
from opv_tpu.core import build_bert_frame, encode_frame  # noqa: E402
from opv_tpu.rx.fast import rx_fast as rx_fast_j  # noqa: E402
from opv_tpu.stream.multichannel import MultiChannelDemodulator as MCJ  # noqa: E402
from opv_tpu.stream.wideband import WidebandReceiver as WidebandJ  # noqa: E402
from opv_tpu.tx import modulate_frames, tx_flush_zeros  # noqa: E402
from opv_tpu_torch.stream import MultiChannelDemodulator as MCT  # noqa: E402
from opv_tpu_torch.stream import multichannel  # noqa: E402
from opv_tpu_torch.stream import WidebandReceiver as WidebandT  # noqa: E402

Q_TOL = 1e-5
#: a leakage frame's sync quality, port against JAX (7.7e-4 seen; the
#: card against the cpu in chip_smoke.py allows the same, WB_GARBAGE_Q_TOL)
GARBAGE_Q_TOL = 1e-3
LEAK_METRIC = 100
SPF = CONFIG.samples_per_frame


@pytest.fixture(scope="module")
def capture10():
    frames = build_bert_frame("W5NYV", frame_num=np.arange(10))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64), frames


@pytest.fixture(autouse=True)
def pinned_cfo(monkeypatch):
    """Every block of the port's receivers runs rx_fast with the JAX
    package's CFO estimate of the same block, and its slots are held to
    the JAX rx_fast's."""
    port_rx_fast = multichannel.rx_fast

    def step(block, max_frames):
        x = block.numpy()
        want = {k: np.asarray(v) for k, v in
                rx_fast_j(jnp.asarray(x), max_frames=max_frames).items()}
        out = port_rx_fast(block, torch.from_numpy(np.array(
            want["freq_offset"])), max_frames=max_frames)
        same_block({k: v.numpy() for k, v in out.items()}, want, x)
        return out
    monkeypatch.setattr(multichannel, "rx_fast", step)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], g[1]) == (w[0], w[1]) and abs(g[4] - w[4]) <= 1, \
            (g[0], g[2], g[4], w[0], w[2], w[4])
        assert g[2] == w[2] or g[4] != w[4], (g[0], g[2], g[4], w[2])
        assert abs(g[3] - w[3]) <= Q_TOL, (g[3], w[3])


def _run(mc, x, sizes=None):
    """Feed x (C, n) whole or in the given slice sizes, then flush."""
    if sizes is None:
        return mc.feed(x) + mc.flush()
    res, off = [], 0
    for n in sizes:
        res += mc.feed(x[:, off:off + n])
        off += n
    return res + mc.flush()


def _both(x, channels, sizes=None, **kw):
    got = _run(MCT(channels, device="cpu", **kw), x, sizes)
    want = _run(MCJ(channels, **kw), x, sizes)
    _same(got, want)
    return got


def test_all_frames_once(capture10):
    s, frames = capture10
    res = _both(np.stack([s] * 3), 3, block_frames=4)
    per_chan = {}
    for c, fb, metric, q, pos in res:
        per_chan.setdefault(c, []).append((pos, fb, metric))
    assert set(per_chan) == {0, 1, 2}
    for c, lst in per_chan.items():
        lst.sort()
        assert len(lst) == 10
        got = np.stack([np.frombuffer(fb, np.uint8) for _, fb, _ in lst])
        np.testing.assert_array_equal(got, frames)
        assert all(m == 0 for _, _, m in lst)
        positions = np.array([p for p, _, _ in lst])
        assert np.abs(np.diff(positions) - SPF).max() <= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_slicing_invariance(capture10, seed):
    """Random feed slices (numpy seed) give the whole-feed tuples."""
    s, _ = capture10
    x = np.stack([s, s])
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < x.shape[1]:
        sizes.append(int(rng.integers(1, 120_000)))
    mc = MCT(2, block_frames=3, device="cpu")
    res = _run(mc, x, sizes)
    _same(res, _run(MCJ(2, block_frames=3), x, sizes))
    _same(res, _run(MCT(2, block_frames=3, device="cpu"), x))
    assert sum(1 for r in res if r[0] == 0) == 10
    assert sum(1 for r in res if r[0] == 1) == 10
    assert mc.perfect == 20 and mc.decoded == 20


def test_channel_offset_independence(capture10):
    s, _ = capture10
    n = np.arange(len(s))
    x = np.stack([s, np.concatenate([np.zeros(17, np.complex64), s[:-17]]),
                  (s * np.exp(-2j * np.pi * 700.0 * n / CONFIG.sample_rate)
                   ).astype(np.complex64)])
    res = _both(x, 3, block_frames=5)
    counts = [sum(1 for r in res if r[0] == c) for c in range(3)]
    assert counts[0] == 10 and counts[1] == 10 and counts[2] >= 9
    for c, fb, metric, q, pos in res:
        f = np.frombuffer(fb, np.uint8)
        assert f[12] == f[13] - 1


@pytest.mark.parametrize("cut,n_frames", [
    (5 * SPF + 960 + SPF // 5, 5),
    (3 * SPF + 960 + SPF // 5, 3),
    (5 * SPF + 960 + 2143 * 40, 5),        # frame 6's payload a sample short
    (5 * SPF + 960 + 2143 * 40 + 2, 6),    # ... and whole (its start may sit
], ids=["mid5", "mid3", "short", "whole"])  # a sample late, the plateau)
def test_flush_no_phantom_frames(capture10, cut, n_frames):
    """A stream cut mid-frame yields only its complete frames: a frame whose
    payload reaches one sample into the zero padding is dropped, one that
    just fits is kept."""
    s, frames = capture10
    res = _both(s[None, :cut], 1, block_frames=4)
    got = np.stack([np.frombuffer(fb, np.uint8) for _, fb, *_ in res])
    np.testing.assert_array_equal(got, frames[:n_frames])


def test_feed_takes_tensors_and_counts(capture10):
    """A tensor feed gives the numpy feed's tuples; max_frames_per_block
    and the window geometry are the JAX receiver's."""
    s, _ = capture10
    x = np.stack([s, s])
    mj = MCJ(2, block_frames=2, max_frames_per_block=5)
    mt = MCT(2, block_frames=2, max_frames_per_block=5, device="cpu")
    assert (mt.advance, mt.overlap, mt.window, mt.max_frames) == \
        (mj.advance, mj.overlap, mj.window, mj.max_frames)
    _same(_run(mt, torch.from_numpy(x)), _run(mj, x))
    assert (mt.decoded, mt.perfect) == (mj.decoded, mj.perfect) == (20, 20)
    with pytest.raises(ValueError, match="2 channels"):
        mt.feed(np.zeros((3, 10), np.complex64))
    assert mt.flush() == []


# ----------------------------------------------- WidebandReceiver("fast")


@pytest.fixture(scope="module")
def two_carriers():
    k = 4
    sets = {0: build_bert_frame("W5NYV", frame_num=np.arange(6)),
            2: build_bert_frame("TEST", frame_num=np.arange(6))}
    return k, sets, capture(k, sets)


def test_wideband_fast_engine_matches_jax(two_carriers):
    """TestWidebandReceiver.test_streaming_decode's signal through the fast
    engine, ragged feeds: both packages' tuples, and every frame of
    channels 0 and 2 once, byte-exact."""
    k, sets, x = two_carriers
    res = ragged(WidebandT(k, block_frames=3, engine="fast", device="cpu"), x)
    want = ragged(WidebandJ(k, block_frames=3, engine="fast"), x)
    sent = {bytes(f) for fs in sets.values() for f in fs}
    assert len(res) == len(want)
    for g, w in zip(res, want):
        assert (g[0], g[4]) == (w[0], w[4])
        if g[1] in sent or w[1] in sent:
            assert (g[1], g[2]) == (w[1], w[2]) and abs(g[3] - w[3]) <= Q_TOL
        else:
            assert min(g[2], w[2]) > LEAK_METRIC
            assert abs(g[3] - w[3]) <= GARBAGE_Q_TOL, (g[0], g[4], g[3], w[3])
    for c, expected in sets.items():
        lst = sorted((r for r in res if r[0] == c), key=lambda r: r[4])
        sent = [r for r in lst if r[2] <= 16]
        assert len(sent) == 6, (c, [(r[2], r[4]) for r in lst])
        np.testing.assert_array_equal(
            np.stack([np.frombuffer(r[1], np.uint8) for r in sent]), expected)


def test_wideband_fast_engine_refusals():
    with pytest.raises(ValueError, match="pipeline=True requires "
                       "engine='locked'"):
        WidebandT(4, engine="fast", pipeline=True, device="cpu")
    rx = WidebandT(4, engine="fast", device="cpu")
    with pytest.raises(RuntimeError, match="engine='locked'"):
        rx.state_tree()
    assert rx.stats() == {} and rx.decoded == 0
    with pytest.raises(NotImplementedError, match="item 12"):
        WidebandT(4, engine="fast", mesh=object(), device="cpu")
