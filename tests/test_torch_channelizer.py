"""The port's analysis channelizer (opv_tpu_torch.rx.channelizer) against
the JAX package's on the CPU: the float64 tables exactly, the polyphase
legs and the channel bank within 1e-5 of max|y| (the port sums the DFT
product in float64, the JAX package in float32), the simulation helpers
within float64 rounding; then TestPrototype and TestChannelize of
tests/test_channelizer.py on the port."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.rx import channelizer as J
from opv_tpu.core import build_bert_frame as build_bert_frame_j
from opv_tpu_torch.core.framing import build_bert_frame
from opv_tpu_torch.rx import channelizer as T
from opv_tpu_torch.rx.locked import rx_locked

CPU = torch.device("cpu")
#: |port - JAX| <= Y_RTOL * max|JAX|: float32 sums of 12 taps and 2K DFT
#: terms taken in another order (measured 1.2e-7 at K = 4, 2.3e-7 at 64)
Y_RTOL = 1e-5
KS = (2, 4, 8, 64)


def _wideband(k: int, seed: int, m: int = 50, extra: int = 5):
    """Gaussian complex64 at sigma 8000 per component, long enough for m
    output samples plus a ragged tail."""
    rng = np.random.default_rng(seed)
    n = k * (12 + m) + extra
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * 8000).astype(np.complex64)


@pytest.mark.parametrize("k", KS)
def test_tables_equal_jax(k):
    assert np.array_equal(T.prototype_filter(k), J.prototype_filter(k))
    assert np.array_equal(T.prototype_filter(k, 8, 6.0),
                          J.prototype_filter(k, 8, 6.0))
    assert np.array_equal(T.dft_kernel(k), J.dft_kernel(k))


@pytest.mark.parametrize("k", KS)
def test_legs_and_channelize_match_jax(k):
    x = _wideband(k, seed=k)
    legs_j = np.asarray(J.polyphase_legs(jnp.asarray(x), k))
    legs_t = T.polyphase_legs(torch.from_numpy(x), k).numpy()
    assert legs_t.shape == legs_j.shape and legs_t.dtype == np.float32
    assert np.abs(legs_t - legs_j).max() <= Y_RTOL * np.abs(legs_j).max()
    y_j = np.asarray(J.channelize(jnp.asarray(x), k))
    y_t = T.channelize(torch.from_numpy(x), k)
    assert y_t.dtype == torch.complex64 and y_t.is_contiguous()
    assert y_t.shape == y_j.shape and y_t.shape[0] == k
    assert np.abs(y_t.numpy() - y_j).max() <= Y_RTOL * np.abs(y_j).max()


@pytest.mark.parametrize("k", KS)
def test_channelize_cols_is_a_column_slice(k):
    """A slice of the DFT kernel's channel columns gives those rows of the
    whole bank (the port's own), and JAX's channelize_cols on the same
    slice."""
    x = _wideband(k, seed=100 + k)
    lo, hi = k // 4, k // 4 + max(1, k // 2)
    kern = T.dft_kernel(k).astype(np.float32)[:, lo:hi]
    full = T.channelize(torch.from_numpy(x), k)
    cols = T.channelize_cols(torch.from_numpy(x), torch.from_numpy(kern), k)
    assert torch.equal(cols, full[lo:hi])
    want = np.asarray(J.channelize_cols(jnp.asarray(x), jnp.asarray(kern), k))
    assert np.abs(cols.numpy() - want).max() <= Y_RTOL * np.abs(want).max()


def test_msk_wideband_and_synthesis_match_jax():
    k = 4
    frames = build_bert_frame("W5NYV", frame_num=np.arange(2))
    assert np.array_equal(frames, build_bert_frame_j("W5NYV",
                                                     frame_num=np.arange(2)))
    s_j = J.msk_wideband(frames, k)
    s_t = T.msk_wideband(frames, k, device=CPU)
    assert s_t.dtype == torch.complex128 and s_t.shape == s_j.shape
    # the same float64 expression; sin/cos may differ in the last bit
    amp = 16383.0
    assert np.abs(s_t.numpy() - s_j).max() <= 1e-12 * amp
    sig = {1: s_j, 3: s_j[: len(s_j) // 3]}
    n = len(s_j) + 777
    w_j = J.synthesize_wideband(sig, k, n)
    w_t = T.synthesize_wideband(sig, k, n, device=CPU)
    assert w_t.dtype == torch.complex128 and w_t.shape == (n,)
    assert np.abs(w_t.numpy() - w_j).max() <= 1e-11 * amp


def test_wideband_test_channels_equal_jax():
    for k in range(1, 70):
        assert T.wideband_test_channels(k) == J.wideband_test_channels(k)


# TestPrototype and TestChannelize of tests/test_channelizer.py, on the port


def test_unit_passband():
    h = T.prototype_filter(8)
    assert abs(h.sum() - 1.0) < 1e-12
    w = np.exp(-2j * np.pi * np.arange(len(h)) * 1.0 / 8)
    assert abs((h * w).sum()) < 1e-3


def test_tone_separation():
    """Pure tones at channel centres land in their channels only."""
    k = 8
    n = 40960
    t = np.arange(n)
    x = sum(np.exp(2j * np.pi * c * t / k) * amp
            for c, amp in [(0, 1.0), (2, 2.0), (5, 3.0)])
    y = T.channelize(torch.from_numpy(x.astype(np.complex64)), k).numpy()
    power = (np.abs(y[:, 50:-50]) ** 2).mean(axis=1)
    assert power[0] > 100 * max(power[1], power[3], power[4])
    assert power[2] > 100 * power[1]
    assert power[5] > 100 * power[4]
    assert abs(np.sqrt(power[2]) - 2.0) < 0.05


def test_opv_multicarrier_decode():
    """3 OPV transmissions on a 4-channel wideband grid: channelize, then
    the port's rx_locked recovers each channel's own frames."""
    k = 4
    sets = {0: build_bert_frame("W5NYV", frame_num=np.arange(2)),
            1: build_bert_frame("KI5ZDF", frame_num=10 + np.arange(2)),
            3: build_bert_frame("TEST", frame_num=20 + np.arange(2))}
    sig = {c: T.msk_wideband(f, k, device=CPU) for c, f in sets.items()}
    n = max(len(s) for s in sig.values())
    x = T.synthesize_wideband(sig, k, n, device=CPU)
    y = T.channelize(x.to(torch.complex64), k)
    out = rx_locked(y, n_frames=2)
    fv = out["frame_valid"].numpy()
    frames = out["frames"].numpy()
    metrics = out["metrics"].numpy()
    for c, expected in sets.items():
        assert fv[c].all(), f"channel {c} frames invalid"
        np.testing.assert_array_equal(frames[c], expected)
        assert (metrics[c] <= 16).all(), f"channel {c} metrics {metrics[c]}"
    assert not fv[2].any() or (metrics[2] > 100).all()


def test_complex128_input_runs_in_float64():
    """complex128 wideband gives complex128 channels (float64 legs), as
    the JAX package's channelize does under x64."""
    k = 4
    x = _wideband(k, seed=7).astype(np.complex128)
    y = T.channelize(torch.from_numpy(x), k)
    assert y.dtype == torch.complex128
    want = np.asarray(J.channelize(jnp.asarray(x), k))
    assert np.abs(y.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_channelize_routes_the_cpu_to_the_twin(monkeypatch):
    """CPU tensors, complex64 and complex128, run the plain twin through
    registry.channelize: the kernel's wrapper is never reached."""
    from opv_tpu_torch.ops import channelize as C

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(C, "channelize_cuda", no_kernel)
    rng = np.random.default_rng(5)
    n = 8 * 12 * 20 + 5
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    for dt in (torch.complex64, torch.complex128):
        xt = torch.from_numpy(x).to(dt)
        want = T.channelize_cols(xt, T.dft_kernel(8), 8)
        got = T.channelize(xt, 8)
        assert got.dtype == dt and torch.equal(got, want)


def test_channelize_kernel_wrapper_raises_before_the_library(monkeypatch):
    """With the device check faked, the kernel's wrapper refuses complex128,
    non-contiguous, 2-D and too-short input before it builds or loads the
    library; registry.launch_counts() names the kernel and counts none."""
    from opv_tpu_torch.ops import build, registry
    from opv_tpu_torch.ops import channelize as C

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(C, "_on_card", lambda t: True)
    monkeypatch.setattr(build, "library", no_library)
    registry.reset_launch_counts()
    x = torch.zeros(4 * 12 * 10, dtype=torch.complex64)
    for bad, what in ((x.to(torch.complex128), "complex128"),
                      (x[::2], "contiguous"),
                      (x.reshape(2, -1), "contiguous"),
                      (x[: 4 * 12 - 1], "fewer")):
        with pytest.raises(ValueError, match=what):
            C.channelize_cuda(bad, 4, 12)
    with pytest.raises(ValueError, match="k >= 1"):
        C.channelize_cuda(x, 0, 12)
    assert registry.launch_counts()["channelize"] == 0


@pytest.mark.parametrize("k", [1, 3, 64])
def test_channelize_kernel_operand_is_the_twins_kernel(k):
    """The kernel's (wr, wi) pairs are dft_kernel(k)'s re-leg rows rounded
    to float32 as the twin rounds them, and the im-leg rows are their exact
    negation (-wi, wr)."""
    from opv_tpu_torch.ops.channelize import _dft_pairs
    kern = torch.from_numpy(T.dft_kernel(k)).to(torch.float32)
    pairs = _dft_pairs(k, torch.device("cpu"))
    assert pairs.shape == (k, k, 2) and pairs.is_contiguous()
    assert torch.equal(pairs, kern[0::2])
    assert torch.equal(kern[1::2], torch.stack([-pairs[..., 1],
                                                pairs[..., 0]], -1))
