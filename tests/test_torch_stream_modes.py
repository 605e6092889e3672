"""The port's streaming engine in its other modes (CPU tensors, the twins)
against the JAX package's engine on the scenarios of
tests/test_locked_stream.py: pipelined (TestPipelined), eager serving
(TestEager) and the strided re-hunt (TestSplitHunt); and the strided hunt's
functions (rx_locked_hunt_strided, rx_locked_reacquire_cfo,
rx_locked_reacquire_strided) against the JAX package's on a gap-burst
window.

Tolerance: identical tuple streams — channel, frame bytes, Viterbi metric
and absolute position equal, sync quality within 1e-4.  The functions:
p0, acquired, burst_only, frames and metrics identical, CFO within 1 Hz,
frac within 1e-3 samples."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import opv_tpu.stream as sj
import opv_tpu_torch.stream as st
from opv_tpu.rx import locked as lj
from opv_tpu_torch.rx import locked as lt
from stream_scenarios import (SPF, assert_same_stream, drifted, gap_burst,
                              run, signal)


def _port(channels, **kw):
    return st.LockedStreamDemodulator(channels, device="cpu", **kw)


# -- pipelined ------------------------------------------------------------ #

def _pipelined_case(case):
    """(x, chunk) of TestPipelined's scenarios."""
    if case == "clean_multichannel":
        s, _ = signal(10)
        return np.stack([s, np.concatenate([np.zeros(17, np.complex64),
                                            s])[:len(s)]]), 123_457
    if case == "lock_loss_cfo":
        return gap_burst()[0][None, :], 70_001
    return drifted(40)[0][None, :], 200_003


@pytest.mark.parametrize("case", ["clean_multichannel", "lock_loss_cfo",
                                  "clock_drift"])
def test_pipelined_matches_jax_and_synchronous(case):
    """The port's pipelined engine emits the JAX pipelined engine's tuples
    and its own synchronous engine's, with the same counters: every
    misprediction path runs (hunting blocks, a lock gain, the drop
    relaunch; retime blocks and backward wraps under drift)."""
    x, chunk = _pipelined_case(case)
    kw = dict(block_frames=4)
    sd_j = sj.LockedStreamDemodulator(x.shape[0], pipeline=True, **kw)
    want = run(sd_j, x, chunk)
    sd_p = _port(x.shape[0], pipeline=True, **kw)
    got = run(sd_p, x, chunk)
    sd_s = _port(x.shape[0], **kw)
    sync = run(sd_s, x, chunk)
    assert_same_stream(got, want)
    assert got == sync
    for k in ("decoded", "perfect", "reacquisitions", "refreshes"):
        assert getattr(sd_p, k) == getattr(sd_j, k) == getattr(sd_s, k), k
    if case == "clean_multichannel":
        assert len(got) == 20
    if case == "clock_drift":
        assert sd_p.refreshes >= 2


def test_pipelined_checkpoint_requires_quiesce():
    s, _ = signal(8)
    sd = _port(1, block_frames=4, pipeline=True)
    out = sd.feed(s[None, :])
    assert sd._pending is not None
    with pytest.raises(RuntimeError, match="flush"):
        sd.state_tree()
    out += sd.flush()
    sd.state_tree()                       # quiesced: fine
    assert out == run(_port(1, block_frames=4), s[None, :])


# -- eager ---------------------------------------------------------------- #

@pytest.fixture(scope="module")
def serving():
    """Eight frames 123 samples into the stream, (1, N)."""
    s, _ = signal(8)
    return np.concatenate([np.zeros(123, np.complex64), s])[None]


@pytest.mark.parametrize("chunk", [SPF, 70_001])
def test_eager_tuple_identical_clean(serving, chunk):
    want = run(sj.LockedStreamDemodulator(1, block_frames=1, eager=True),
               serving, chunk=chunk)
    got = run(_port(1, block_frames=1, eager=True), serving, chunk=chunk)
    assert_same_stream(got, want)
    assert got == run(_port(1, block_frames=1), serving, chunk=chunk)
    assert len(got) == 8


def test_eager_one_frame_earlier_at_cadence(serving):
    """Fed frame-sized chunks, each steady frame comes out with the feed
    carrying the next frame: eager's cumulative count leads the window-gated
    engine's by one from the first steady block on, feed for feed as the
    JAX package's eager engine emits."""
    x = serving

    def per_feed(sd):
        counts = [len(sd.feed(x[:, off:off + SPF]))
                  for off in range(0, x.shape[1], SPF)]
        return counts, len(sd.flush())

    (base, base_tail) = per_feed(_port(1, block_frames=1))
    (eag, eag_tail) = per_feed(_port(1, block_frames=1, eager=True))
    assert (eag, eag_tail) == per_feed(
        sj.LockedStreamDemodulator(1, block_frames=1, eager=True))
    assert sum(base) + base_tail == 8 and sum(eag) + eag_tail == 8
    cb, ce = np.cumsum(base), np.cumsum(eag)
    first = int(np.argmax(ce > 0))
    assert (ce[first:] - cb[first:] == 1).all(), (base, eag)


def test_eager_through_gap_and_reacquire():
    """A noise gap (drop, flywheel, re-hunt) takes the eager gate off; the
    lifecycle still emits the window-gated engine's tuples."""
    s, _, _ = gap_burst(seed=7, n1=4, n2=4, gap_frames=7, cfo=0.0, shift=0)
    x = s[None, :]
    want = run(sj.LockedStreamDemodulator(1, block_frames=1, eager=True), x,
               chunk=SPF)
    sd = _port(1, block_frames=1, eager=True)
    got = run(sd, x, chunk=SPF)
    assert_same_stream(got, want)
    assert got == run(_port(1, block_frames=1), x, chunk=SPF)
    assert sd.reacquisitions >= 1


def test_eager_int8_agc(serving):
    """eager on int8 rows with AGC: the JAX eager engine's tuples; against
    the window-gated engine the JAX package pins payloads and positions
    only (eager resolves blocks one window tail earlier, so the AGC
    statistics span other feeds)."""
    def both(eager):
        kw = dict(block_frames=1, dtype="int8", eager=eager)
        got = run(_port(1, **kw), serving, chunk=SPF)
        assert_same_stream(got, run(sj.LockedStreamDemodulator(1, **kw),
                                    serving, chunk=SPF))
        return got

    gated, eager = both(False), both(True)
    assert [(r[0], r[1], r[4]) for r in eager] == \
        [(r[0], r[1], r[4]) for r in gated]
    assert len(eager) == 8


def test_eager_big_block_engine_stays_window_gated():
    """A drop inside an eager block is possible once block_frames exceeds
    sync_miss_limit, so eager stays off there."""
    assert not _port(1, block_frames=6, eager=True)._eager
    assert _port(1, block_frames=5, eager=True)._eager


# -- strided hunt --------------------------------------------------------- #

@pytest.fixture(scope="module")
def gap_stream():
    s, f1, f2 = gap_burst(cfo=500.0, shift=0)
    return s[None, :], {bytes(r) for r in f1} | {bytes(r) for r in f2}


def test_split_hunt_matches_jax_and_monolithic(gap_stream):
    """hunt_stride=2 emits the JAX engine's hunt_stride=2 tuples; against
    hunt_stride=1 (TestSplitHunt) the same tuple count and positions and
    the same bytes for every true frame, all 12 recovered, 3
    re-acquisitions each.  Flywheel frames over the gap may differ: they
    decode noise at whatever frac each hunt refined."""
    x, truth = gap_stream
    kw = dict(block_frames=4, dtype="float32")
    sd_j = sj.LockedStreamDemodulator(1, hunt_stride=2, **kw)
    want = run(sd_j, x, chunk=70_001)
    outs = {}
    for hs in (1, 2):
        sd = _port(1, hunt_stride=hs, **kw)
        assert sd.hunt_stride == hs
        outs[hs] = run(sd, x, chunk=70_001)
        assert sd.reacquisitions == 3
    assert_same_stream(outs[2], want)
    assert len(outs[1]) == len(outs[2])
    for ra, rb in zip(outs[1], outs[2]):
        assert ra[4] == rb[4]
        if ra[1] in truth or rb[1] in truth:
            assert ra[1] == rb[1]
    assert sum(1 for r in outs[2] if r[1] in truth) == 12


def test_hunt_stride_must_divide_the_symbol():
    with pytest.raises(ValueError, match="hunt_stride"):
        _port(1, hunt_stride=3)


@pytest.fixture(scope="module")
def hunt_window(gap_stream):
    """(3, window) complex64 of block_frames 4 from the gap-burst stream:
    burst 1 from its start (a kept grid), noise then burst 2 at +500 Hz
    from mid-window, and noise only; the kept channel's grid and CFO."""
    x = gap_stream[0][0]
    window = 5 * SPF + 1040
    b2 = len(x) - len(signal(6)[0])          # burst 2's first sync
    starts = (0, b2 - 2 * SPF - 12_345, 7 * SPF)
    w = np.stack([x[s:s + window] for s in starts])
    keep = np.array([True, False, False])
    p0 = np.array([0, 0, 0], np.int32)
    foff = np.zeros(3, np.float32)
    return w, keep, p0, foff


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("keep_all_false", [False, True])
def test_hunt_strided_and_cfo_match_jax(hunt_window, stride, keep_all_false):
    w, keep, p0, foff = hunt_window
    if keep_all_false:
        keep = np.zeros_like(keep)
    h_t = lt.rx_locked_hunt_strided(torch.from_numpy(w), torch.from_numpy(p0),
                                    torch.from_numpy(foff),
                                    torch.from_numpy(keep), stride)
    h_j = lj.rx_locked_hunt_strided(jnp.asarray(w), jnp.asarray(p0),
                                    jnp.asarray(foff), jnp.asarray(keep),
                                    stride=stride)
    for k in ("p0", "acquired", "burst_only"):
        assert h_t[k].dtype == (torch.int32 if k == "p0" else torch.bool), k
        np.testing.assert_array_equal(h_t[k].numpy(), np.asarray(h_j[k]),
                                      err_msg=k)
    assert h_t["acquired"][1]              # burst 2 is hunted
    cfo_t = lt.rx_locked_reacquire_cfo(torch.from_numpy(w), h_t["p0"],
                                       torch.from_numpy(foff),
                                       torch.from_numpy(keep))
    cfo_j = lj.rx_locked_reacquire_cfo(jnp.asarray(w), h_j["p0"],
                                       jnp.asarray(foff), jnp.asarray(keep))
    assert cfo_t.dtype == torch.float32
    np.testing.assert_allclose(cfo_t[:2].numpy(), np.asarray(cfo_j)[:2],
                               rtol=0, atol=1.0)
    assert abs(float(cfo_t[1]) - 500.0) < 25.0


def test_reacquire_strided_matches_jax_chain(hunt_window):
    """rx_locked_reacquire_strided against the JAX engine's four-program
    chain (stream/locked.py hunt2, cfo2, sref2, reacq_body) on the same
    window."""
    w, keep, p0, foff = hunt_window
    frac = np.array([0.25, 0.0, 0.0], np.float32)
    got = lt.rx_locked_reacquire_strided(
        torch.from_numpy(w), torch.from_numpy(p0), torch.from_numpy(foff),
        torch.from_numpy(keep), 4, torch.from_numpy(frac), 2)
    xj = jnp.asarray(w)
    h = lj.rx_locked_hunt_strided(xj, jnp.asarray(p0), jnp.asarray(foff),
                                  jnp.asarray(keep), stride=2)
    f2 = lj.rx_locked_reacquire_cfo(xj, h["p0"], jnp.asarray(foff),
                                    jnp.asarray(keep))
    p0r, frac_r, _ = lj.refine_timing_locked(xj, h["p0"], f2, n_frames=4)
    p0f = jnp.where(h["acquired"], p0r, h["p0"])
    fr = jnp.where(h["acquired"], frac_r, jnp.asarray(frac))
    want = dict(lj.rx_locked_steady(xj, p0f, f2, n_frames=4, frac=fr))
    want["burst_only"] = h["burst_only"]
    for k in ("frames", "metrics", "decode_ok", "frame_valid", "p0",
              "burst_only"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # channel 2 holds noise only: its grid CFO is a float32 coin toss
    np.testing.assert_allclose(got["freq_offset"][:2].numpy(),
                               np.asarray(want["freq_offset"])[:2],
                               rtol=0, atol=1.0)
    np.testing.assert_allclose(got["frac"].numpy(), np.asarray(want["frac"]),
                               rtol=0, atol=1e-3)
    assert int(got["metrics"][1, 0]) == 0   # burst 2's first frame
