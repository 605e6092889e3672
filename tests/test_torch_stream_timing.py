"""The port's streaming engine (CPU tensors) against the JAX package's on
the timing-refresh and buffer scenarios of tests/test_locked_stream.py:
clock-drift refresh (float32 and int8 rows), the retime adoption gate,
timing metrics, and bf16 / int8 buffers with complex and int16 feeds.

Tolerance: identical tuple streams — channel, frame bytes, Viterbi metric
and absolute position equal, sync quality within 1e-4 — and equal
lifecycle counters.  int8 engines run with agc=False in both packages
(the port has no int8 AGC yet)."""

import numpy as np
import pytest

import opv_tpu.stream as sj
import opv_tpu_torch.stream as st
from stream_scenarios import SPF, assert_same_stream, drifted, run, signal


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_clock_drift_refresh_matches_jax(dtype):
    """+16 ppm clock drift (~55 samples of slip over 40 frames): the
    timing refresh walks p0 along with zero frame loss, identically."""
    x, frames = drifted(40)
    kw = dict(block_frames=4, dtype=dtype, agc=False)
    sd_j = sj.LockedStreamDemodulator(1, **kw)
    want = run(sd_j, x[None, :])
    sd_t = st.LockedStreamDemodulator(1, device="cpu", **kw)
    got = run(sd_t, x[None, :])
    assert_same_stream(got, want)
    assert sd_t.refreshes == sd_j.refreshes >= 2
    assert [r[1] for r in got[:39]] == [bytes(f) for f in frames[:39]]
    np.testing.assert_array_equal(sd_t.p0, sd_j.p0)
    np.testing.assert_allclose(sd_t._fold_w, sd_j._fold_w, rtol=1e-12)


def _adoption_run(mod):
    """TestAdoptionGate's run on one package's engine: warm the fold
    accumulator on a clean stream, nudge the carried frac, then feed two
    crafted same-sign trust-sized retime outliers.  Returns the engine,
    the tuples, the accumulator weight before the outliers and the grid
    before and after them."""
    s, _ = signal(60)
    x = s[None, :]
    kw = {} if mod is sj else {"device": "cpu"}
    sd = mod.LockedStreamDemodulator(1, block_frames=4, dtype="float32", **kw)
    sd._WARM_METRIC_MIN = -1.0      # retime every block regardless
    step, off, out = 4 * SPF, 0, []
    while sd._fold_w[0] < sd._FOLD_DEEP + 2:
        out += sd.feed(x[:, off:off + step])
        off += step
    w0 = float(sd._fold_w[0])
    nudge = -0.3 if sd.frac[0] >= 0.35 else 0.3
    # a new array, not a write into the old one: on the CPU the JAX
    # engine's cached device copy of frac may share the host array's
    # memory, and would then carry the nudge into a later block unseen
    sd.frac = sd.frac + np.float32(nudge)
    outlier = np.int32(5 if nudge < 0 else -5)
    grid0 = (sd._abs_base + sd.p0[0] + sd.frac[0]) % SPF
    fold_avg = (sd._fold_acc / np.maximum(sd._fold_w[:, None], 1e-9)).copy()

    def fake_retime(buf, p, f, sc):
        return (np.full(1, outlier, np.int32),
                sd.frac.astype(np.float32).copy(), fold_avg.copy())

    sd._retime = fake_retime
    for _ in range(2):
        sd.refresh[:] = True
        out += sd.feed(x[:, off:off + step])
        off += step
    grid = (sd._abs_base + sd.p0[0] + sd.frac[0]) % SPF
    return sd, out, w0, grid0, grid


def test_adoption_gate_matches_jax():
    """A deep accumulator vetoes two same-sign outliers it does not
    corroborate in magnitude; the grow-into-EMA weight grows by exactly
    one per accumulated window — identically in both engines."""
    sd_j, want, w0_j, g0_j, g_j = _adoption_run(sj)
    sd_t, got, w0_t, g0_t, g_t = _adoption_run(st)
    assert_same_stream(got, want)
    assert w0_t == w0_j and abs(w0_t - round(w0_t)) < 1e-9
    assert sd_t._fold_w[0] == pytest.approx(w0_t + 2) == sd_j._fold_w[0]
    assert abs(g0_t - g0_j) < 1e-3 and abs(g_t - g_j) < 1e-3
    drift = (g_t - g0_t + SPF / 2) % SPF - SPF / 2
    assert abs(drift) <= 1.0


def test_timing_metrics_match_jax():
    s, _ = signal(6)
    sd_j = sj.LockedStreamDemodulator(1, block_frames=2, timing=True)
    want = run(sd_j, s[None, :])
    sd_t = st.LockedStreamDemodulator(1, block_frames=2, timing=True,
                                      device="cpu")
    got = run(sd_t, s[None, :])
    assert_same_stream(got, want)
    assert len(got) == 6
    assert [b["tag"] for b in sd_t.block_stats] == \
        [b["tag"] for b in sd_j.block_stats]
    for b in sd_t.block_stats:
        assert set(b) == {"tag", "device_wait_ms", "host_ms"}
        assert b["device_wait_ms"] >= 0 and b["host_ms"] >= 0
    assert sd_t.block_stats[0]["tag"] == "reacquire"
    got_st, want_st = sd_t.stats(), sd_j.stats()
    assert set(got_st) == set(want_st)
    for k in ("blocks", "blocks_by_program", "decoded", "perfect",
              "reacquisitions", "refreshes"):
        assert got_st[k] == want_st[k], k
    quiet = st.LockedStreamDemodulator(1, block_frames=2, device="cpu")
    run(quiet, s[None, :])
    assert quiet.block_stats == []


@pytest.fixture(scope="module")
def noisy5():
    """Five frames in AWGN (sigma 40) after 777 samples of silence, and
    the float32 JAX engine's tuples on 40,000-sample complex feeds."""
    s, frames = signal(5)
    rng = np.random.default_rng(7)
    noisy = s + (40.0 * (rng.standard_normal(len(s))
                         + 1j * rng.standard_normal(len(s)))).astype(np.complex64)
    sig = np.concatenate([np.zeros(777, np.complex64), noisy])[None, :]
    return sig, _fed(sj.LockedStreamDemodulator(1, dtype="float32"), sig)


def _fed(sd, sig, as_int16=False):
    out = []
    for i in range(0, sig.shape[1], 40_000):
        chunk = sig[:, i:i + 40_000]
        if as_int16:
            pairs = np.stack([chunk.real, chunk.imag], -1)
            chunk = np.clip(np.round(pairs), -32768, 32767).astype(np.int16)
        out += sd.feed(chunk)
    return out + sd.flush()


@pytest.mark.parametrize("dtype,as_int16", [("float32", False),
                                            ("bfloat16", False),
                                            ("bfloat16", True),
                                            ("int8", False), ("int8", True)])
def test_buffer_dtype_and_int16_feed_match_jax(noisy5, dtype, as_int16):
    """Each buffer dtype and feed form: the tuples of the JAX engine of the
    same dtype, and the float32 engine's frames and positions."""
    sig, ref = noisy5
    kw = dict(dtype=dtype, agc=False)
    want = (ref if (dtype, as_int16) == ("float32", False) else
            _fed(sj.LockedStreamDemodulator(1, **kw), sig, as_int16))
    got = _fed(st.LockedStreamDemodulator(1, device="cpu", **kw), sig, as_int16)
    assert_same_stream(got, want)
    assert len(ref) == 5
    assert [(t[0], t[1], t[4]) for t in got] == [(t[0], t[1], t[4]) for t in ref]
