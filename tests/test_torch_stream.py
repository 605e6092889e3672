"""The port's streaming engine (opv_tpu_torch.stream, on CPU tensors: the
twins) against the JAX package's LockedStreamDemodulator on the lifecycle
scenarios of tests/test_locked_stream.py: continuous decode, lock loss and
re-acquisition, the flywheel, sub-row feeds, the tail flush and burst
salvage.

Tolerance: identical tuple streams — channel, frame bytes, Viterbi metric
and absolute position equal, sync quality within 1e-4 — and equal
lifecycle counters."""

import numpy as np
import pytest

import opv_tpu.stream as sj
import opv_tpu_torch.stream as st
from stream_scenarios import SPF, assert_same_stream, gap_burst, run, signal


def _port(channels, **kw):
    return st.LockedStreamDemodulator(channels, device="cpu", **kw)


def _both(x, chunk=None, **kw):
    """Run the JAX engine and the port's on x; (port tuples, port engine,
    JAX tuples, JAX engine)."""
    sd_j = sj.LockedStreamDemodulator(x.shape[0], **kw)
    want = run(sd_j, x, chunk)
    sd_t = _port(x.shape[0], **kw)
    got = run(sd_t, x, chunk)
    assert_same_stream(got, want)
    for k in ("decoded", "perfect", "reacquisitions", "refreshes"):
        assert getattr(sd_t, k) == getattr(sd_j, k), k
    np.testing.assert_array_equal(sd_t.locked, sd_j.locked)
    return got, sd_t, want, sd_j


@pytest.fixture(scope="module")
def continuous():
    """Two channels of a 10-frame stream (channel 1 delayed 17 samples)
    and the JAX engine's tuples for it."""
    s, frames = signal(10)
    x = np.stack([s, np.concatenate([np.zeros(17, np.complex64), s])[:len(s)]])
    want = run(sj.LockedStreamDemodulator(2, block_frames=4), x)
    return x, frames, want


def test_continuous_decode_matches_jax(continuous):
    x, frames, want = continuous
    got = run(_port(2, block_frames=4), x)
    assert_same_stream(got, want)
    for c in (0, 1):
        mine = [r for r in got if r[0] == c]
        assert [r[1] for r in mine] == [bytes(f) for f in frames]
        assert all(r[2] == 0 for r in mine)
        assert np.all(np.diff([r[4] for r in mine]) == SPF)


def test_chunk_slicing_invariance(continuous):
    """Awkward chunk sizes give the very tuples of one whole feed."""
    x, _, want = continuous
    whole = run(_port(2, block_frames=4), x)
    assert run(_port(2, block_frames=4), x, chunk=123_457) == whole
    assert_same_stream(whole, want)


def test_lock_loss_and_reacquire_with_cfo():
    """Burst 1, a noise gap (lock dropped after 5 flywheel misses), burst 2
    at another sample phase and +500 Hz: re-hunted and decoded exactly."""
    s, f1, f2 = gap_burst()
    got, sd, _, _ = _both(s[None, :], block_frames=4)
    assert [r[1] for r in got if r[2] == 0] == \
        [bytes(f) for f in f1] + [bytes(f) for f in f2]
    assert sd.reacquisitions >= 1


def test_reacquire_within_drop_block():
    """Lock drops at a block's first slot and the next burst starts later
    in that window: the same-window re-hunt keeps its first frame."""
    s, f1, f2 = gap_burst(seed=7, n1=3, n2=3, cfo=0.0, shift=13)
    got, _, _, _ = _both(s[None, :], chunk=70_001, block_frames=4)
    perfect = [r for r in got if r[2] == 0]
    assert [r[1] for r in perfect] == \
        [bytes(f) for f in f1] + [bytes(f) for f in f2]
    b2_start = len(s) - len(signal(3)[0])
    assert abs(perfect[3][4] - b2_start) <= 1


def test_flywheel_emits_through_short_fade():
    s, frames = signal(12)
    x = s.copy()
    x[5 * SPF:7 * SPF] *= 0.001          # frames 5-6 lose their sync
    got, sd, _, _ = _both(x[None, :], block_frames=4)
    have = {r[1] for r in got if r[2] == 0}
    assert all(bytes(frames[k]) in have for k in (0, 1, 2, 3, 4, 7, 8, 9, 10, 11))
    assert sd.reacquisitions <= 1 and sd.locked.all()


def test_sub_row_feeds_accumulate_via_pend():
    """Feeds shorter than one 40-sample row pend on the host and decode
    as one whole feed does."""
    s, frames = signal(3)
    x = s[None, :]

    def fed(sd):
        out, off, k = [], 0, 0
        sizes = [7, 13, 39, 1, 23, 41]
        while off < x.shape[1]:
            take = min(sizes[k % len(sizes)] * (1 if k < 12 else 4099),
                       x.shape[1] - off)
            out.extend(sd.feed(x[:, off:off + take]))
            off += take
            k += 1
        return out + sd.flush()

    want = fed(sj.LockedStreamDemodulator(1, block_frames=4))
    got = fed(_port(1, block_frames=4))
    assert_same_stream(got, want)
    assert got == run(_port(1, block_frames=4), x)
    assert [r[1] for r in got] == [bytes(f) for f in frames]


def test_flush_rejects_partial_tail_frame():
    s, frames = signal(6)
    got, _, _, _ = _both(s[: 5 * SPF + SPF // 2][None, :], block_frames=4)
    assert [r[1] for r in got if r[2] == 0] == [bytes(f) for f in frames[:5]]


def _salvage_case(case):
    """(x, chunk, engine kwargs) of tests/test_locked_stream.py's
    TestBurstSalvage cases."""
    s, _ = signal(1)
    if case == "two_frames":
        s, _ = signal(2)
        x = np.zeros((1, 10 * SPF), np.complex64)
        x[0, SPF + 7_777:SPF + 7_777 + len(s)] = s
        return x, None, {}
    if case == "noise":
        rng = np.random.default_rng(23)
        x = (rng.standard_normal((1, 12 * SPF)) +
             1j * rng.standard_normal((1, 12 * SPF))).astype(np.complex64) * 8000.0
        return x, None, {}
    if case == "overlap_tail":                # owned by window 2, not 1
        window, advance = 5 * SPF + 1040, 4 * SPF
        x = np.zeros((1, window + 2 * advance), np.complex64)
        x[0, advance + 500:advance + 500 + len(s)] = s
        return x, 100_003, {}
    x = np.zeros((1, 8 * SPF), np.complex64)
    pos = 2 * SPF + (12_345 if case == "single" else 0)
    x[0, pos:pos + len(s)] = s
    return x, None, ({"single_frame_burst": False} if case == "opt_out" else {})


@pytest.mark.parametrize("case", ["single", "overlap_tail", "two_frames",
                                  "opt_out", "noise"])
def test_burst_salvage_matches_jax(case):
    x, chunk, kw = _salvage_case(case)
    got, sd, _, _ = _both(x, chunk=chunk, block_frames=4, **kw)
    _, frames = signal(2 if case == "two_frames" else 1)
    if case == "two_frames":
        assert [r[1] for r in got] == [bytes(f) for f in frames]
    elif case == "opt_out":
        assert got == []
    elif case == "noise":                     # never locks on noise
        assert len(got) <= 5 and all(r[2] > 500 for r in got)
        assert sd.perfect == 0
    else:
        assert [r[1] for r in got] == [bytes(frames[0])]
    if case != "two_frames":
        assert not sd.locked.any()
