"""The port's re-acquire and retime functions (CPU tensors, the twins)
against the JAX package's, on the same complex64 inputs made from seeds:
rx_locked_reacquire (keep all False / mixed / all True, a carried frac, a
single-frame burst, noise only), refine_timing_locked (integer and
half-sample delays, a slab 0 past the block's end) and rx_locked_retime;
and every entry point on complex128 input, which runs in float64.

Tolerances: frames, metrics, frame_valid, decode_ok, p0 and burst_only
identical; freq_offset within 1 Hz, frac within 1e-3 samples, sync_q
within 1e-4, the timing fold within 1e-5 of its largest magnitude."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.rx import locked as lj
from opv_tpu_torch.rx import locked as lt
from stream_scenarios import SPF, signal

EXACT = ("frames", "metrics", "frame_valid", "decode_ok", "p0", "burst_only")
CLOSE = {"freq_offset": 1.0, "frac": 1e-3, "sync_q": 1e-4}
N_FRAMES = 2
#: a streaming window of block_frames = 2
WINDOW = (N_FRAMES + 1) * SPF + 1040


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _assert_same(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in CLOSE.items():
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def _fold_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def block():
    """(4, WINDOW) complex64: a continuous stream, the same in AWGN (sigma
    2000) 13 samples late, a burst from sample 40,000 at +300 Hz, and a
    single frame at 1.3 frame intervals; plus each channel's true grid."""
    s, _ = signal(4)
    one, _ = signal(1)
    x = np.zeros((4, WINDOW), np.complex64)
    x[0] = s[:WINDOW]
    x[1, 13:] = s[:WINDOW - 13]
    t = np.arange(WINDOW - 40_000)
    x[2, 40_000:] = s[:WINDOW - 40_000] * np.exp(
        2j * np.pi * 300.0 * t / CONFIG.sample_rate).astype(np.complex64)
    p3 = int(1.3 * SPF)
    x[3, p3:p3 + len(one)] = one
    rng = np.random.default_rng(11)
    x[1] += (2000.0 * (rng.standard_normal(WINDOW)
                       + 1j * rng.standard_normal(WINDOW))).astype(np.complex64)
    return x, np.array([0, 13, 40_000, p3], np.int32)


@pytest.mark.parametrize("keep", [(False,) * 4, (True, False, True, False),
                                  (True,) * 4])
@pytest.mark.parametrize("with_frac", [False, True])
def test_reacquire_matches_jax(block, keep, with_frac):
    x, grid = block
    keep = np.array(keep)
    p0_old = np.where(keep, grid, 0).astype(np.int32)
    foff_old = np.array([0.0, 0.0, 300.0, 0.0], np.float32) * keep
    frac = np.array([0.5, 0.25, 0.125, 0.75], np.float32) if with_frac else None
    want = lj.rx_locked_reacquire(_j(x), _j(p0_old), _j(foff_old), _j(keep),
                                  n_frames=N_FRAMES,
                                  frac_old=None if frac is None else _j(frac))
    got = lt.rx_locked_reacquire(_t(x), _t(p0_old), _t(foff_old), _t(keep),
                                 N_FRAMES, frac_old=None if frac is None else _t(frac))
    _assert_same(got, want)
    # every hunted channel found its burst; channel 3's lone frame is
    # flagged burst_only, not locked
    p0 = got["p0"].numpy()
    assert np.all(np.abs(p0[~keep] - grid[~keep]) <= 1)
    assert got["burst_only"].numpy().tolist() == [False, False, False, not keep[3]]
    if keep.any():
        np.testing.assert_array_equal(p0[keep], grid[keep])
        if frac is not None:
            np.testing.assert_array_equal(got["frac"].numpy()[keep], frac[keep])


def test_reacquire_noise_only_stays_unlocked():
    """Weak pure noise: the hunt finds nothing, so both keep the carried
    grid and frac, flag no burst, and no slot meets the hunting
    thresholds (an engine stays unlocked).  The CFO estimated on noise is
    not held: its grid argmax and discriminator angle are decided by
    float32 rounding (ROADMAP queue 3), and with it the garbage frames."""
    rng = np.random.default_rng(23)
    x = (rng.standard_normal((2, WINDOW))
         + 1j * rng.standard_normal((2, WINDOW))).astype(np.complex64)
    p0_old = np.array([123, 4567], np.int32)
    frac = np.array([0.25, 0.5], np.float32)
    zeros, keep = np.zeros(2, np.float32), np.zeros(2, bool)
    want = lj.rx_locked_reacquire(_j(x), _j(p0_old), _j(zeros), _j(keep),
                                  n_frames=N_FRAMES, frac_old=_j(frac))
    got = lt.rx_locked_reacquire(_t(x), _t(p0_old), _t(zeros), _t(keep),
                                 N_FRAMES, frac_old=_t(frac))
    for out in (got, {k: _t(v) for k, v in want.items()}):
        np.testing.assert_array_equal(out["p0"].numpy(), p0_old)
        np.testing.assert_array_equal(out["frac"].numpy(), frac)
        hunt = ((out["sync_q"] >= CONFIG.sync_hunt_norm_thresh)
                & (out["sync_raw"] >= CONFIG.sync_hunt_raw_thresh))
        assert not bool(hunt.any()) and not bool(out["burst_only"].any())
        assert not bool(out["frame_valid"].any())


def _stream(n_frames, delays, n, noise=0.0, seed=7, shift=0.0):
    s, _ = signal(n_frames)
    if shift:                                 # advanced by `shift` samples
        s = ((1 - shift) * s[:-1] + shift * s[1:]).astype(np.complex64)
    x = np.zeros((len(delays), n), np.complex64)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s[: n - d]
    if noise:
        rng = np.random.default_rng(seed)
        x += (rng.standard_normal(x.shape)
              + 1j * rng.standard_normal(x.shape)).astype(np.complex64) * noise
    return x


def _refine_both(x, p0, n_frames, foff=None):
    foff = np.zeros(len(p0), np.float32) if foff is None else foff
    pj, fj, foldj = lj.refine_timing_locked(_j(x), _j(p0), _j(foff),
                                            n_frames=n_frames)
    pt, ft, foldt = lt.refine_timing_locked(_t(x), _t(p0), _t(foff), n_frames)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-3)
    _fold_close(foldt, foldj)
    return pt.numpy() + ft.numpy()


def test_refine_timing_integer_delay_matches_jax():
    """tests/test_locked.py's integer-delay case: jittered single-shot
    locks in AWGN (sigma 4000), and a clean capture from three starts."""
    n = len(signal(6)[0]) + 6000
    delays = np.array([40, 233, 5000])
    x = _stream(6, delays, n, noise=4000.0)
    est = _refine_both(x, (delays + [2, -3, 1]).astype(np.int32), 6)
    np.testing.assert_allclose(est, delays + 0.5, atol=1.5)
    clean = _stream(6, (5000,) * 3, n)
    est = _refine_both(clean, np.array([4995, 5000, 5003], np.int32), 6)
    np.testing.assert_allclose(est, 5000.5, atol=0.1)


def test_refine_timing_half_sample_matches_jax():
    """A stream advanced by half a sample: the sync sits at d - 0.5, the
    apex plateau centre at d."""
    d = 1000
    x = _stream(5, (d,), len(signal(5)[0]) + 4000, shift=0.5)
    est = _refine_both(x, np.array([d], np.int32), 5)
    assert abs(est[0] - d) < 0.45


def test_refine_timing_slab0_past_end_keeps_p0():
    """A p0 whose first slab runs past the block's end (valid0 False):
    both keep the hunt's p0 with frac 0.5 and an all-zero fold."""
    x = _stream(2, (0, 0), WINDOW)
    p0 = np.array([100, WINDOW - 500], np.int32)
    pj, fj, foldj = lj.refine_timing_locked(_j(x), _j(p0), _j(np.zeros(2, np.float32)),
                                            n_frames=2)
    pt, ft, foldt = lt.refine_timing_locked(_t(x), _t(p0), torch.zeros(2), 2)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-3)
    _fold_close(foldt, foldj)
    assert pt[1] == p0[1] and ft[1] == 0.5 and not bool(foldt[1].any())


def test_retime_matches_jax(block):
    """The folded refresh anchored one frame after p0, on the block's
    grids nudged off by -3..+4 samples (deltas clipped to +-20)."""
    x, grid = block
    p0 = (grid + np.array([3, -2, 4, 0])).astype(np.int32) % SPF
    foff = np.array([0.0, 0.0, 300.0, 0.0], np.float32)
    for n_frames in (1, N_FRAMES):
        dj, fj, foldj = lj.rx_locked_retime(_j(x), _j(p0), _j(foff), n_frames=n_frames)
        dt, ft, foldt = lt.rx_locked_retime(_t(x), _t(p0), _t(foff), n_frames)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-3)
        _fold_close(foldt, foldj)
        assert dt.dtype == torch.int32 and int(dt.abs().max()) <= 20
    np.testing.assert_array_equal(dt.numpy()[:2], [-3, 2])


#: complex128 input (the float64 path) against the JAX package's: CFO
#: within 1e-3 Hz (float32 ulps of the refinement at ~1 kHz), frac within
#: 1e-6 samples, sync_q within 1e-9 and the timing fold within 1e-9 of its
#: largest magnitude (float64 sums in another order; the locked soft
#: stage's tone tables are float32 in both packages, their sin/cos an ulp
#: apart); frames, metrics, validity, p0 and burst_only identical
C128_CLOSE = {"freq_offset": 1e-3, "frac": 1e-6, "sync_q": 1e-9}


@pytest.mark.parametrize("fn", ["rx_locked", "rx_locked_steady",
                                "rx_locked_reacquire", "refine_timing_locked",
                                "rx_locked_retime"])
def test_complex128_input_matches_jax(fn):
    """complex128 samples run in float64 through every entry point, as the
    JAX package computes them: the same results on the same input (a
    stream at delays 0 and 29, the second in AWGN)."""
    x = _stream(3, (0, 29), 2 * SPF + 2000, noise=1500.0).astype(np.complex128)
    x[1] += 500.0 * np.random.default_rng(2).standard_normal(x.shape[1])
    p0 = np.array([0, 29], np.int32)
    foff = np.array([0.0, 15.0], np.float32)
    keep = np.array([True, False])
    calls = {
        "rx_locked": lambda m, s: m.rx_locked(s, n_frames=1),
        "rx_locked_steady": lambda m, s: m.rx_locked_steady(
            s, m_(m, p0), m_(m, foff), 1),
        "rx_locked_reacquire": lambda m, s: m.rx_locked_reacquire(
            s, m_(m, p0), m_(m, foff), m_(m, keep), 1),
        "refine_timing_locked": lambda m, s: m.refine_timing_locked(
            s, m_(m, p0), m_(m, foff), 2),
        "rx_locked_retime": lambda m, s: m.rx_locked_retime(
            s, m_(m, p0), m_(m, foff), 1)}

    def m_(m, a):
        return _t(a) if m is lt else _j(a)
    got = calls[fn](lt, _t(x))
    want = calls[fn](lj, _j(x))
    if isinstance(got, dict):
        got = {k: v.numpy() for k, v in got.items()}
        want = {k: np.asarray(v) for k, v in want.items()}
        assert got["sync_q"].dtype == np.float64
        for k in EXACT:
            if k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k, tol in C128_CLOSE.items():
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg=k)
        assert int(got["n_decoded"]) == int(want["n_decoded"]) > 0
    else:
        (pt, ft, foldt), (pj, fj, foldj) = got, want
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                                   atol=C128_CLOSE["frac"])
        assert foldt.dtype == torch.float64
        foldj = np.asarray(foldj)
        np.testing.assert_allclose(foldt.numpy(), foldj, rtol=0,
                                   atol=1e-9 * np.abs(foldj).max())
