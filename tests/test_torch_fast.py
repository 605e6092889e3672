"""The port's feed-forward dense receiver (opv_tpu_torch/rx/fast.py:
detect_frames, extract_payloads_dense, rx_fast) against opv_tpu/rx/fast.py
on the CPU, on inputs made from numpy seeds and the golden captures.

Tolerances.  detect_frames and extract_payloads_dense given the same
arrays: every output identical.  rx_fast given the JAX package's CFO
estimate: starts, valid, frames, metrics and frame_valid identical, sync_q
within Q_TOL.  One divergence is inherent, not a fault: the MSK sync apex
is a two-sample plateau on which the raw correlation of adjacent offsets
is equal up to float32 rounding, so the two packages' sums (taken in
another order) may put the peak one sample apart.  Such a slot must be a
plateau tie in the port's own raw correlation (within PLATEAU_RTOL), with
the same frame bytes and validity, and its metric may differ (a sample off
the grid; ROADMAP queue 3).  With the CFO estimated by each package (the
grid argmax on a curve flat to ~1e-6, up to 75 Hz apart on clean
captures): frames and frame_valid identical.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.rx import fast as fj
from opv_tpu_torch.rx import fast as ft

SPS = CONFIG.samples_per_symbol
SPF = CONFIG.samples_per_frame
Q_TOL = 1e-5
#: a one-sample start difference is a plateau tie when the port's raw
#: correlation at the two samples agrees within this (a few float32 ulps
#: of a 24-term sum)
PLATEAU_RTOL = 1e-6


def _load(golden_dir, name):
    raw = np.fromfile(golden_dir / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)


@pytest.fixture(scope="module")
def bert3(golden_dir):
    golden = np.frombuffer((golden_dir / "bert3.frames").read_bytes(),
                           np.uint8).reshape(-1, CONFIG.frame_bytes)
    return _load(golden_dir, "bert3"), golden


def _jax(x, **kw):
    return {k: np.asarray(v) for k, v in fj.rx_fast(jnp.asarray(x), **kw).items()}


def _port(x, freq_offset=None, **kw):
    fo = None if freq_offset is None else torch.from_numpy(np.array(freq_offset))
    out = ft.rx_fast(torch.from_numpy(np.array(x)), freq_offset=fo, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(got, want, x):
    """rx_fast results of the port (got) and the JAX package (want) on the
    same samples and CFO.  Returns the number of plateau-tie slots."""
    np.testing.assert_array_equal(got["frame_valid"], want["frame_valid"])
    np.testing.assert_array_equal(got["freq_offset"], want["freq_offset"])
    np.testing.assert_allclose(got["sync_q"], want["sync_q"], rtol=0,
                               atol=Q_TOL)
    np.testing.assert_array_equal(got["frames"], want["frames"])
    ties = got["starts"] != want["starts"]
    np.testing.assert_array_equal(got["metrics"][~ties], want["metrics"][~ties])
    if ties.any():
        soft = ft.dense_soft(torch.from_numpy(np.array(x)),
                             torch.from_numpy(np.array(want["freq_offset"])))
        raw = ft.dense_sync(soft)[0].numpy()
        for c, k in zip(*np.nonzero(ties)):
            a, b = (int(v["starts"][c, k]) - 24 * SPS for v in (got, want))
            assert abs(a - b) == 1 and want["frame_valid"][c, k], (c, k, a, b)
            assert abs(raw[c, a] - raw[c, b]) <= PLATEAU_RTOL * abs(raw[c, a]), \
                (c, k, raw[c, a], raw[c, b])
    assert int(got["n_decoded"]) == int(want["n_decoded"])
    return int(ties.sum())


def _both(x, max_frames):
    """The JAX package's rx_fast, then the port's given the JAX CFO."""
    want = _jax(x, max_frames=max_frames)
    got = _port(x, freq_offset=want["freq_offset"], max_frames=max_frames)
    return got, want


# ---------------------------------------------------------------- rx_fast


@pytest.mark.parametrize("estimate", [False, True], ids=["jax_cfo", "own_cfo"])
def test_arbitrary_sample_offset(bert3, estimate):
    """TestFastPipeline.test_arbitrary_sample_offset: bert3 at sample
    offsets 0, 7, 23, 39, cut to 220,000 samples (two frames fit)."""
    s, golden = bert3
    x = np.stack([np.concatenate([np.zeros(o, np.complex64), s])[:220_000]
                  for o in (0, 7, 23, 39)])
    got, want = _both(x, 4)
    if estimate:
        got = _port(x, max_frames=4)
        np.testing.assert_array_equal(got["frame_valid"], want["frame_valid"])
        np.testing.assert_array_equal(got["frames"], want["frames"])
    else:
        _assert_same(got, want, x)
    for c in range(4):
        np.testing.assert_array_equal(got["frames"][c][got["frame_valid"][c]],
                                      golden[:2])


@pytest.mark.parametrize("estimate", [False, True], ids=["jax_cfo", "own_cfo"])
def test_per_channel_cfo(bert3, estimate):
    """TestFastPipeline.test_per_channel_cfo: 0, -400, -900 Hz, estimated
    per channel."""
    s, golden = bert3
    n = np.arange(len(s))
    x = np.stack([(s * np.exp(2j * np.pi * f * n / CONFIG.sample_rate))
                  .astype(np.complex64) for f in (0.0, -400.0, -900.0)])
    got, want = _both(x, 6)
    if estimate:
        got = _port(x, max_frames=6)
        np.testing.assert_array_equal(got["frame_valid"], want["frame_valid"])
        np.testing.assert_array_equal(got["frames"], want["frames"])
        offs = got["freq_offset"]
        assert abs((offs[1] - offs[0]) + 400.0) < 30
        assert abs((offs[2] - offs[0]) + 900.0) < 30
    else:
        _assert_same(got, want, x)
    for c in range(3):
        np.testing.assert_array_equal(got["frames"][c][got["frame_valid"][c]],
                                      golden)


def test_two_bursts_different_sample_phase(bert3):
    """TestMultiBurst: two 2-frame bursts 50,017 samples apart (another
    sample phase) in one block both decode, through the one-frame-apart
    neighbour rule of the phase vote."""
    s, golden = bert3
    two = s[: 2 * SPF + 40]
    x = np.concatenate([two, np.zeros(50_017, np.complex64), two])[None]
    got, want = _both(x, 8)
    _assert_same(got, want, x)
    fv = got["frame_valid"][0]
    clean = got["metrics"][0][fv] == 0
    assert clean.sum() == 4
    np.testing.assert_array_equal(got["frames"][0][fv][clean],
                                  np.concatenate([golden[:2], golden[:2]]))
    assert len(np.unique(got["starts"][0][fv][clean] % SPS)) == 2
    assert (got["metrics"][0][fv][~clean] > 100).all()


def test_pure_noise(bert3):
    """TestFastPipeline.test_noise_rejection (numpy seed 3): at most one
    false frame per channel, and the JAX package's slots exactly."""
    rng = np.random.default_rng(3)
    x = ((rng.standard_normal((2, 150_000)) +
          1j * rng.standard_normal((2, 150_000))) * 1000).astype(np.complex64)
    got, want = _both(x, 4)
    _assert_same(got, want, x)
    assert int(_port(x, max_frames=4)["n_decoded"]) <= 2


def test_own_tx_many_frames():
    """TestFastOwnTX: six frames of the fast TX on three channels, with
    CFO estimation off (the transmitter's own grid)."""
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.tx import modulate_frames, tx_flush_zeros
    frames = build_bert_frame("KI5ZDF", frame_num=np.arange(6))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    x = np.stack([s, np.roll(s, 11), np.roll(s, 29)])
    want = _jax(x, max_frames=8, estimate_cfo_flag=False)
    got = _port(x, max_frames=8, estimate_cfo_flag=False)
    _assert_same(got, want, x)
    assert got["frame_valid"].sum() == 18


def test_short_capture_and_complex128_raise():
    """A capture shorter than a frame raises; complex128 (refused until the
    float64 path was ported) runs in float64, as the JAX package's does
    (tests/test_torch_precision.py holds its results)."""
    n = 87_640
    with pytest.raises(ValueError, match=r"at least one full frame of "
                       r"samples \(87640\), got 87639"):
        ft.rx_fast(torch.zeros((1, n - 1), dtype=torch.complex64))
    out = ft.rx_fast(torch.zeros((1, n), dtype=torch.complex128),
                     estimate_cfo_flag=False, max_frames=3)
    assert out["sync_q"].dtype == torch.float64 and int(out["n_decoded"]) == 0
    out = ft.rx_fast(torch.zeros((2, n), dtype=torch.complex64),
                     estimate_cfo_flag=False, max_frames=3)
    assert out["frames"].shape == (2, 3, 134) and int(out["n_decoded"]) == 0
    assert out["starts"].dtype == torch.int32


# ------------------------------------------------------- detect_frames


def _hand_made(seed=0, m_soft=200_000, rows=3):
    """(raw, norm, soft) float32 with background below the hunt
    thresholds: soft ~ N(0, 1) (a true sync's spread of tap energy),
    raw in [0, 4000), norm in [0, 0.5)."""
    rng = np.random.default_rng(seed)
    m = m_soft - 23 * SPS
    soft = rng.standard_normal((rows, m_soft)).astype(np.float32)
    raw = rng.uniform(0, 4000, (rows, m)).astype(np.float32)
    norm = rng.uniform(0, 0.5, (rows, m)).astype(np.float32)
    return raw, norm, soft


def _plant(raw, norm, c, n, value):
    raw[c, n] = value
    norm[c, n] = 0.9


def _detect_both(raw, norm, soft, max_frames):
    want = [np.asarray(a) for a in fj.detect_frames(
        jnp.asarray(raw), jnp.asarray(norm), jnp.asarray(soft), max_frames)]
    got = [a.numpy() for a in ft.detect_frames(
        torch.from_numpy(raw), torch.from_numpy(norm), torch.from_numpy(soft),
        max_frames)]
    for g, w, name in zip(got, want, ("starts", "valid", "q")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_detect_more_hits_than_slots():
    """30 qualifying peaks at one phase: the first 8 in index order; a row
    with none gives the padding (start 959, invalid, q = norm[:, 0])."""
    raw, norm, soft = _hand_made()
    for k in range(30):
        _plant(raw, norm, 0, 1005 + 2000 * k, 10_000 + 7 * k)
        _plant(raw, norm, 2, 3005 + 1000 * k, 20_000 - k)
    starts, valid, q = _detect_both(raw, norm, soft, 8)
    np.testing.assert_array_equal(starts[0], 1005 + 2000 * np.arange(8) + 960)
    assert valid[0].all() and valid[2].all() and not valid[1].any()
    np.testing.assert_array_equal(starts[1], 959)
    np.testing.assert_array_equal(q[1], norm[1, 0])


def test_detect_no_peak_row_and_spare_slots():
    """A row whose only hits sit on a rising edge (no local max) has
    p* = 0; a row with fewer hits than slots pads the rest."""
    raw, norm, soft = _hand_made(seed=1)
    for n in range(5000, 5030):          # a ramp: each exceeds the last
        _plant(raw, norm, 0, n, 6000 + 10 * n)
    raw[0, 5030] = 1e6                    # ...below the norm threshold
    _plant(raw, norm, 1, 40_000, 9000)
    starts, valid, q = _detect_both(raw, norm, soft, 4)
    assert not valid[0].any()
    assert valid[1].tolist() == [True, False, False, False]


@pytest.mark.parametrize("dphase,accepted", [(1, True), (-1, True),
                                             (2, False), (20, False)])
def test_detect_phase_vote_neighbours(dphase, accepted):
    """The strongest peak fixes p* (phase 5); a peak at p* +- 1 is
    accepted, at +-2 or more only with a hit one frame away."""
    raw, norm, soft = _hand_made(seed=2)
    _plant(raw, norm, 0, 1005, 50_000)
    _plant(raw, norm, 0, 9005 + dphase, 20_000)
    starts, valid, _ = _detect_both(raw, norm, soft, 4)
    assert (9005 + dphase + 960 in starts[0][valid[0]]) == accepted


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_detect_off_phase_pair_one_frame_apart(offset):
    """Two off-phase peaks exactly one frame apart (+-1 sample) validate
    each other (a second burst at its own sample phase)."""
    raw, norm, soft = _hand_made(seed=3)
    _plant(raw, norm, 0, 1005, 50_000)
    _plant(raw, norm, 0, 20_020, 20_000)
    _plant(raw, norm, 0, 20_020 + SPF + offset, 20_000)
    starts, valid, _ = _detect_both(raw, norm, soft, 4)
    assert sorted(starts[0][valid[0]]) == [1965, 20_980, 20_980 + SPF + offset]


def test_detect_tap_guard_plateau_and_fit():
    """A window with one dominant tap is rejected; of two equal adjacent
    raw values the first is the peak; a payload past the stream's end is
    rejected."""
    raw, norm, soft = _hand_made(seed=4)
    m_soft = soft.shape[1]
    _plant(raw, norm, 0, 1005, 50_000)
    _plant(raw, norm, 0, 5005, 30_000)
    soft[0, 5005 + 7 * SPS] = 1000.0           # tap 7 of that window
    _plant(raw, norm, 0, 9005, 30_000)
    _plant(raw, norm, 0, 9006, 30_000)
    limit = m_soft - 24 * SPS - 2143 * SPS      # a payload fits below it
    last = limit - 1 - (limit - 1 - 1005) % SPS
    _plant(raw, norm, 0, last, 30_000)
    _plant(raw, norm, 0, last + SPS, 30_000)
    starts, valid, _ = _detect_both(raw, norm, soft, 8)
    assert sorted(starts[0][valid[0]]) == [1965, 9965, last + 960]


def test_extract_payloads_dense_matches_jax():
    """Strided gathers at stride 40, starts clamped at both ends."""
    rng = np.random.default_rng(5)
    soft = rng.standard_normal((2, 100_000)).astype(np.float32)
    starts = np.array([[-5, 0, 959, 14_279], [14_280, 14_281, 50_000, 7]],
                      np.int32)
    want = np.asarray(fj.extract_payloads_dense(jnp.asarray(soft),
                                                jnp.asarray(starts)))
    got = ft.extract_payloads_dense(torch.from_numpy(soft),
                                    torch.from_numpy(starts)).numpy()
    np.testing.assert_array_equal(got, want)
