"""The port's WidebandReceiver (opv_tpu_torch.stream.wideband) against
the JAX package on the CPU: every
TestWidebandReceiver and TestWidebandWaterfall scenario of
tests/test_wideband.py run on both packages with the same feeds, with the
test's own assertions on the port's tuples (the steady path and the
checkpoints: tests/test_torch_wideband_state.py).

Tuples are held equal in channel, bytes, metric and position, with the
sync quality within 1e-4, on every channel that carries a transmission.
A quiet channel next to an active one decodes adjacent-channel leakage as
garbage frames (metrics in the thousands; the JAX test only bounds them
above 100).  Their soft values sit so close to the 3-bit quantizer's steps
that float32 rounding anywhere on the path (channelizer, soft stage)
moves a few bits: there the two packages agree in channel, position and
sync quality, and both metrics exceed 100 (ROADMAP queue 3, inherent
divergences)."""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_channelizer import msk_wideband, synthesize_wideband  # noqa: E402

from opv_tpu.config import CONFIG  # noqa: E402
from opv_tpu.core import build_bert_frame  # noqa: E402
from opv_tpu.stream.wideband import WidebandReceiver as WidebandJ  # noqa: E402
from opv_tpu_torch.stream.wideband import WidebandReceiver as WidebandT  # noqa: E402

Q_TOL = 1e-4
#: the JAX test's bound for a quiet channel's leakage frames
LEAK_METRIC = 100


def port(k, **kw):
    return WidebandT(k, device="cpu", **kw)


def capture(k, sets, lead=2000):
    """{channel: frames} -> wideband complex128 with each transmission
    starting `lead` channel samples in (the filter's warm-up)."""
    pad = np.zeros(lead * k, np.complex128)
    wb = {c: np.concatenate([pad, msk_wideband(f, k)])
          for c, f in sets.items()}
    return synthesize_wideband(wb, k, max(map(len, wb.values())))


def same_tuples(got, want, sets):
    """got (port) against want (JAX): the same count, channels and
    positions, q within Q_TOL; bytes and metric equal wherever either tuple
    is a transmitted frame (sets: {channel: frames}); elsewhere (leakage,
    a false lock's garbage) both metrics above LEAK_METRIC.  Returns how
    many such tuples differed."""
    sent = {bytes(f) for fs in sets.values() for f in np.asarray(fs)}
    assert len(got) == len(want)
    leaks = 0
    for g, w in zip(got, want):
        assert (g[0], g[4]) == (w[0], w[4]), (g[0], g[4], w[0], w[4])
        assert abs(g[3] - w[3]) <= Q_TOL
        if (g[1], g[2]) != (w[1], w[2]):
            assert g[1] not in sent and w[1] not in sent, (g[0], g[4])
            assert min(g[2], w[2]) > LEAK_METRIC, (g[0], g[2], w[2], g[4])
            leaks += 1
    return leaks


def ragged(rx, x, seed=0):
    res, off = [], 0
    rng = np.random.default_rng(seed)
    while off < len(x):
        m = int(rng.integers(10_000, 400_000))
        res += rx.feed(x[off:off + m])
        off += m
    return res + rx.flush()


def quanta(rx, x):
    """One window, then quantum-sized feeds (the steady path), then the
    rest, then flush."""
    out = rx.feed(x[: rx.window])
    off = rx.window
    q = rx._quantum
    while off + q <= len(x):
        out += rx.feed(x[off:off + q])
        off += q
    return out + rx.feed(x[off:]) + rx.flush()


@pytest.fixture(scope="module")
def two_carriers():
    k = 4
    sets = {0: build_bert_frame("W5NYV", frame_num=np.arange(6)),
            2: build_bert_frame("TEST", frame_num=np.arange(6))}
    return k, sets, capture(k, sets)


@pytest.mark.parametrize("pipeline,dtype", [
    (False, "auto"), (True, "auto"), (False, "int8")])
def test_streaming_decode(two_carriers, pipeline, dtype):
    """TestWidebandReceiver.test_streaming_decode on both packages."""
    k, sets, x = two_carriers
    kw = dict(block_frames=3, pipeline=pipeline, dtype=dtype)
    res = ragged(port(k, **kw), x)
    same_tuples(res, ragged(WidebandJ(k, **kw), x), sets)
    per = {}
    for c, fb, metric, q, pos in res:
        per.setdefault(c, []).append((pos, np.frombuffer(fb, np.uint8),
                                      metric))
    for c, expected in sets.items():
        lst = sorted(per.get(c, []), key=lambda t: t[0])
        assert len(lst) == 6, f"channel {c}: {len(lst)} frames"
        np.testing.assert_array_equal(np.stack([f for _, f, _ in lst]),
                                      expected)
        assert all(m <= 16 for _, _, m in lst)
    for c in (1, 3):
        assert all(m > LEAK_METRIC for _, _, m in per.get(c, []))


def test_quantum_fast_path_identical():
    """TestWidebandReceiver.test_quantum_fast_path_identical on the port:
    quantum-sized feeds (channelize, then the engine's feed) and
    odd-sized ones (any number of channelize calls per feed) give one
    tuple stream, as do the frame-sized quantum, int8 + AGC (synchronous
    and pipelined); the steady run equals the JAX receiver's."""
    k = 4
    frames = build_bert_frame("W5NYV", frame_num=np.arange(6))
    x = capture(k, {1: frames})
    n = len(x)

    def run(chunks):
        rx = port(k, block_frames=3)
        out, off = [], 0
        for m in chunks:
            out += rx.feed(x[off:off + m])
            off += m
        return out + rx.feed(x[off:]) + rx.flush()

    q = port(k, block_frames=3)._quantum
    win = port(k, block_frames=3).window
    fast = run([win] + [q] * ((n - win) // q))
    odd = run([win - 123, 123 + q // 2, q // 2] + [q] * 2)
    assert fast == odd
    same_tuples(fast, quanta(WidebandJ(k, block_frames=3), x), {1: frames})
    assert quanta(port(k, block_frames=3,
                       quantum_out=CONFIG.samples_per_frame), x) == fast
    i8_frame = quanta(port(k, block_frames=3, dtype="int8",
                           quantum_out=CONFIG.samples_per_frame), x)
    i8_blk = quanta(port(k, block_frames=3, dtype="int8"), x)
    i8_pipe = quanta(port(k, block_frames=3, dtype="int8", pipeline=True), x)
    assert i8_blk == i8_frame
    assert i8_pipe == i8_frame
    got = sorted(((pos, np.frombuffer(fb, np.uint8))
                  for c, fb, m, qq, pos in fast if c == 1 and m <= 16),
                 key=lambda t: t[0])
    np.testing.assert_array_equal(np.stack([f for _, f in got]),
                                  np.asarray(frames))


def test_noisy_channel_matches_jax():
    """TestWidebandWaterfall on both packages: wideband AWGN a little above
    the FEC knee on one channel; the port's tuples are the JAX receiver's
    and the channel keeps a bounded BER."""
    k, nf = 4, 16
    frames = build_bert_frame("W5NYV", frame_num=np.arange(nf))
    x = capture(k, {1: frames})
    n = len(x)
    amp = CONFIG.iq_amplitude
    snr_ch = 10 ** 0.85 / CONFIG.samples_per_symbol
    sigma2 = k * amp * amp / snr_ch
    rng = np.random.default_rng(5)
    x = x + (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)) * np.sqrt(sigma2 / 2)
    rx = port(k, block_frames=4)
    res = rx.feed(x) + rx.flush()
    ref = WidebandJ(k, block_frames=4)
    same_tuples(res, ref.feed(x) + ref.flush(), {1: frames})
    got = np.stack([np.frombuffer(fb, np.uint8) for c, fb, m, q, p in
                    sorted((r for r in res if r[0] == 1),
                           key=lambda r: r[4])])
    assert len(got) >= nf - 1, f"lost {nf - len(got)} frames"
    tb = np.unpackbits(frames, axis=1)
    gb = np.unpackbits(got[:nf], axis=1)
    best = tb.size
    for d in range(0, nf - len(gb) + 1):
        e = int((gb != tb[d:d + len(gb)]).sum()) \
            + (nf - len(gb)) * tb.shape[1]
        best = min(best, e)
    assert best / tb.size <= 3e-2, f"wideband BER {best / tb.size:.3e}"


def test_staggered_starts_false_lock_matches_jax():
    """Every channel of a K = 8 bank carries its own station at full int16
    scale, channel c from channel sample 2000 + 487 c (the chip smoke's
    wideband-64 at a small K).  In both packages channels 2 and 6 hunt
    before their own signal starts and lock on a partial sync match in the
    leakage of a channel that started earlier (q ~ 1, raw above the
    absolute 5000 threshold): they emit garbage on that grid, and with 5
    frames the flywheel holds the false lock over all of their own frames
    (ROADMAP queue 3, open).  The port's tuples are the JAX receiver's.
    At the level an int16 capture of 8 carriers can hold (each x
    32767 / (8 x 16383)) every frame comes out."""
    k, nf = 8, 5
    sets = {c: build_bert_frame(f"CH{c:02d}", frame_num=np.arange(nf) + 100 * c)
            for c in range(k)}
    pad = {c: np.zeros((2000 + 487 * c) * k, np.complex128) for c in sets}
    wb = {c: np.concatenate([pad[c], msk_wideband(f, k)])
          for c, f in sets.items()}
    x = synthesize_wideband(wb, k, max(map(len, wb.values())))
    got = quanta(port(k, block_frames=2), x)
    same_tuples(got, quanta(WidebandJ(k, block_frames=2), x), sets)
    for c, fs in sets.items():
        true = {r[1] for r in got if r[0] == c and r[2] <= 16}
        assert true == (set() if c in (2, 6) else {bytes(f) for f in fs}), c
    garbage = [(r[0], r[4]) for r in got if r[2] > LEAK_METRIC]
    assert {c for c, _ in garbage} == {2, 6} and len(garbage) == 2 * nf
    # the false grid sits before the channel's own first sync
    assert min(p for c, p in garbage if c == 2) < 2000 + 487 * 2
    level = quanta(port(k, block_frames=2), x * (32767 / (k * 16383)))
    for c, fs in sets.items():
        assert {r[1] for r in level if r[0] == c} == {bytes(f) for f in fs}


def test_feed_casts_complex128_and_tensors():
    """feed() takes (n,) complex numpy of any precision or a tensor and
    casts to complex64, as the JAX receiver's does (no float64 refusal)."""
    k = 4
    x = capture(k, {1: build_bert_frame("W5NYV", frame_num=np.arange(3))})
    want = ragged(port(k, block_frames=2), x.astype(np.complex64))
    assert ragged(port(k, block_frames=2), x) == want
    assert ragged(port(k, block_frames=2), torch.from_numpy(x)) == want
    assert len([r for r in want if r[0] == 1 and r[2] <= 16]) == 3


def test_unported_modes_raise_with_their_items():
    """mesh= is ported (tests/test_torch_locked_mesh.py): a mesh without a
    'ch' axis, or one that does not divide K, raises ValueError as the
    JAX receiver's engine does; so does an unknown engine."""
    from opv_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="'ch' axis"):
        WidebandT(4, mesh=make_mesh({"time": 2}, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="divisible"):
        WidebandT(4, mesh=make_mesh({"ch": 3}, devices=["cpu"] * 3))
    with pytest.raises(ValueError):
        WidebandT(4, engine="dense", device="cpu")


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WidebandT(4)
