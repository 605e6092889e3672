"""The locked-grid receiver of the PyTorch port (CPU tensors, the twins)
against the golden captures and the JAX package.

Tolerances: decoded frames, metrics, frame_valid, decode_ok and p0 are
identical; freq_offset within 1 Hz, frac within 1e-3 samples and sync_q
within 1e-4 (float32 sums taken in another order)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.rx import locked as lj
from opv_tpu.rx.cfo import estimate_cfo_batch as cfo_j
from opv_tpu.rx.fast import dense_soft as dense_soft_j, dense_sync as dense_sync_j
from opv_tpu.rx.frame_decoder import quantize_soft as quantize_j
from opv_tpu.tx import modulate_frames, tx_flush_zeros
from opv_tpu_torch.rx import locked as lt
from opv_tpu_torch.rx.cfo import estimate_cfo_batch
from opv_tpu_torch.rx.fast import dense_soft, dense_sync
from opv_tpu_torch.rx.frame_decoder import quantize_soft

EXACT = ("frames", "metrics", "frame_valid", "decode_ok", "p0")
CLOSE = {"freq_offset": 1.0, "frac": 1e-3, "sync_q": 1e-4}


def _load(golden_dir, name):
    raw = np.fromfile(golden_dir / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)


def _delayed(s, offsets):
    return np.stack([np.concatenate([np.zeros(o, np.complex64), s])[:len(s)]
                     for o in offsets])


def _np(d):
    return {k: np.asarray(v) for k, v in d.items() if v is not None}


def _assert_same(got, want):
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in CLOSE.items():
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def tx5():
    """(3, N) complex64: five BERT frames at delays 0/13/37, channel 2 with
    AWGN, plus the transmitted frames."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(5))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    x = _delayed(s, (0, 13, 37))
    rng = np.random.default_rng(3)
    x[2] += (2000.0 * (rng.standard_normal(x[2].shape)
                       + 1j * rng.standard_normal(x[2].shape))).astype(np.complex64)
    return x, np.asarray(frames)


@pytest.mark.parametrize("offsets,n_frames", [((0, 0, 0, 0), 3),
                                              ((0, 13, 27, 39), 2)])
def test_golden_bert3(golden_dir, offsets, n_frames):
    golden = np.frombuffer((golden_dir / "bert3.frames").read_bytes(),
                           dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
    x = _delayed(_load(golden_dir, "bert3"), offsets)
    out = lt.rx_locked(torch.from_numpy(x), n_frames=n_frames)
    assert bool(out["frame_valid"].all())
    assert int(out["metrics"].abs().sum()) == 0
    for c in range(len(offsets)):
        np.testing.assert_array_equal(out["frames"][c].numpy(), golden[:n_frames])
    np.testing.assert_array_equal(out["p0"].numpy(), offsets)


@pytest.mark.parametrize("name,offsets", [("cfo500", (0, 17)), ("awgn8", (0, 29)),
                                          ("awgn7", (0, 29)), ("awgn10", (0, 29)),
                                          ("drift", (0, 29)), ("dropout", (0, 29))])
def test_rx_locked_matches_jax(golden_dir, name, offsets):
    """Held against the JAX package's float32 program, the one its TPU
    runs: with x64 on, its rx_locked carries the CFO in float64 even for
    complex64 input (its freq_offset comes back float64), which on awgn10
    moves one soft value across a quantizer step (metric 1830 against
    1829 in float32)."""
    s = _load(golden_dir, name)
    n_frames = len(s) // CONFIG.samples_per_frame - 1
    x = _delayed(s, offsets)
    with jax.enable_x64(False):
        want = _np(lj.rx_locked(jnp.asarray(x), n_frames=n_frames))
    assert want["freq_offset"].dtype == np.float32
    got = _np({k: v for k, v in lt.rx_locked(torch.from_numpy(x),
                                              n_frames=n_frames).items()})
    _assert_same(got, want)
    golden = np.frombuffer((golden_dir / f"{name}.frames").read_bytes(),
                           dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
    if name == "cfo500":        # clean capture: every frame is the golden one
        for c in range(len(offsets)):
            np.testing.assert_array_equal(got["frames"][c], golden[:n_frames])


def test_steady_from_jax_state(tx5):
    """The port's steady body fed the JAX package's acquired state decodes
    exactly what JAX's steady body decodes, on float32 and int8 window rows
    (fixed and per-channel int8 scale)."""
    x, frames = tx5
    acq = _np(lj.rx_locked(jnp.asarray(x), n_frames=5))
    st = lt.state_from_numpy(acq)
    assert lt.state_from_numpy({"p0": acq["p0"]})["frac"] is None
    assert st["scale"] is None and st["p0"].dtype == torch.int32
    xt = torch.from_numpy(x)
    rows_f = lt.to_window_rows(xt, torch.float32)
    scale = np.array([129.0, 140.0, 155.0], np.float32)
    cases = [(rows_f, None),
             (lt.to_window_rows(xt, torch.int8), None),
             (torch.from_numpy(np.clip(np.round(rows_f.numpy()
                                                / scale[:, None, None]),
                                       -127, 127).astype(np.int8)), scale)]
    for rows, sc in cases:
        want = _np(lj.rx_locked_steady(
            jnp.asarray(rows.numpy()), jnp.asarray(acq["p0"]),
            jnp.asarray(acq["freq_offset"]), n_frames=5,
            scale=None if sc is None else jnp.asarray(sc),
            frac=jnp.asarray(acq["frac"])))
        got = _np(lt.rx_locked_steady(
            rows, st["p0"], st["freq_offset"], 5,
            scale=None if sc is None else torch.from_numpy(sc), frac=st["frac"]))
        _assert_same(got, want)
        assert got["frame_valid"].all()
        for c in range(2):                    # the clean channels
            np.testing.assert_array_equal(got["frames"][c], frames)


def test_window_rows_match_bench_layout(tx5):
    x, _ = tx5
    xt = torch.from_numpy(x)
    pairs = np.stack([x.real, x.imag], -1)[:, : (x.shape[1] // 40) * 40]
    np.testing.assert_array_equal(lt.to_window_rows(xt).numpy(),
                                  pairs.reshape(3, -1, 80).astype(np.float32))
    np.testing.assert_array_equal(
        lt.to_window_rows(xt, torch.int8).numpy(),
        np.clip(np.round(pairs / lt.INT8_SCALE), -127, 127).astype(np.int8)
        .reshape(3, -1, 80))


def test_acquisition_stages_match_jax(tx5):
    """CFO grid, dense correlator, dilated sync, hunt and timing fold."""
    x, _ = tx5
    n = 2 * CONFIG.samples_per_frame
    xs = x[:, :n]
    foff = np.array([0.0, 120.5, -310.25], np.float32)
    # the grid energies agree with a float64 evaluation to 5e-5 (float32
    # sums of 2000 squared magnitudes of 40-tap complex64 dots); the clean-signal
    # argmax sits on a curve flat to ~1e-6 over +-75 Hz, so the estimate
    # itself is held to that band (rx_locked's refinement converges both)
    offs = np.tile(np.arange(-1500.0, 1512.5, 25.0), (3, 1))
    sym = xs[:, :40000].reshape(3, 1000, 40).astype(np.complex128)
    ph = -(2 * np.pi / CONFIG.sample_rate) * np.stack(
        [-CONFIG.freq_dev + offs, CONFIG.freq_dev + offs], -1)[..., None] * np.arange(40)
    e64 = (np.abs(np.einsum("csi,coti->csot", sym, np.exp(1j * ph))) ** 2).sum((1, 3))
    from opv_tpu_torch.rx.cfo import grid_energies
    np.testing.assert_allclose(
        grid_energies(torch.from_numpy(xs), torch.from_numpy(offs)).numpy(),
        e64, rtol=5e-5)
    np.testing.assert_allclose(estimate_cfo_batch(torch.from_numpy(xs)).numpy(),
                               np.asarray(cfo_j(jnp.asarray(xs))), atol=75.0)
    for stride in (1, 2):
        sj = np.array(dense_soft_j(jnp.asarray(xs), jnp.asarray(foff), stride=stride))
        st = dense_soft(torch.from_numpy(xs), torch.from_numpy(foff), stride=stride)
        assert st.shape == sj.shape
        np.testing.assert_allclose(st.numpy(), sj, rtol=0,
                                   atol=1e-5 * np.abs(sj).max())
        rj, nj = (np.array(a) for a in dense_sync_j(jnp.asarray(sj), stride=stride))
        rt, nt = dense_sync(torch.from_numpy(sj), stride=stride)
        np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=1e-5 * np.abs(rj).max())
        np.testing.assert_allclose(nt.numpy(), nj, rtol=0, atol=1e-5)
        hj = [np.asarray(a) for a in lj.hunt_grid(jnp.asarray(rj), jnp.asarray(nj),
                                                  stride=stride)]
        ht = [a.numpy() for a in lt.hunt_grid(torch.from_numpy(rj),
                                              torch.from_numpy(nj), stride=stride)]
        for a, b in zip(ht, hj):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lt.acquire_grid(torch.from_numpy(rj)).numpy(),
                                  np.asarray(lj.acquire_grid(jnp.asarray(rj))))
    p0 = np.array([0, 13, 86000], np.int32)       # the last fold window wraps
    pj, fj = lj.refine_timing_from_raw(jnp.asarray(rj), jnp.asarray(p0))
    pt, ft = lt.refine_timing_from_raw(torch.from_numpy(rj), torch.from_numpy(p0))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-3)


def test_refine_cfo_clamps_late_p0_like_dynamic_slice(tx5):
    """A p0 past N - one frame clamps the slice back in range (no pad)."""
    x, _ = tx5
    p0 = np.array([0, 13, x.shape[1] - 100], np.int32)
    foff = np.array([10.0, -20.0, 0.0], np.float32)
    want = np.asarray(lj.refine_cfo_locked(jnp.asarray(x), jnp.asarray(p0),
                                           jnp.asarray(foff)))
    got = lt.refine_cfo_locked(torch.from_numpy(x), torch.from_numpy(p0),
                               torch.from_numpy(foff)).numpy()
    np.testing.assert_allclose(got, want, atol=1.0)
    sl = lt._slice_rows(torch.arange(10.0).reshape(1, 10), torch.tensor([8]), 4)
    np.testing.assert_array_equal(sl.numpy(), [[6.0, 7.0, 8.0, 9.0]])


def test_fold_estimators_match_jax():
    rng = np.random.default_rng(5)
    seg = (rng.standard_normal((64, 43)) * 100 + 500).astype(np.float32)
    seg[0, :] = np.linspace(1000, 10, 43)       # pk == 0 edge case
    seg[1, :] = np.linspace(10, 1000, 43)       # right-edge peak
    want = np.asarray(lj._fold_est(jnp.asarray(seg)))
    np.testing.assert_allclose(lt._fold_est(torch.from_numpy(seg)).numpy(), want,
                               atol=1e-5)
    np.testing.assert_allclose(lt.fold_est_np(seg), lj.fold_est_np(seg), atol=1e-6)
    assert lt._PB_BIAS == lj._PB_BIAS and lt.INT8_SCALE == lj.INT8_SCALE


def test_quantize_soft_matches_jax():
    rng = np.random.default_rng(9)
    soft = (rng.standard_normal((4, CONFIG.encoded_bits)) * 1e6).astype(np.float32)
    soft[1] = 0.0                               # all-zero payload: not ok
    qj, okj = quantize_j(jnp.asarray(soft))
    qt, okt = quantize_soft(torch.from_numpy(soft))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_entry_point_runs_on_cpu_tensors():
    from opv_tpu_torch.entry import entry
    step, (example,) = entry(device="cpu")
    frames, metrics, fv, n = step(example)
    assert frames.shape == (1, 1, CONFIG.frame_bytes)
    assert metrics.shape == fv.shape == (1, 1) and int(n) == int(fv.sum())
    assert int(metrics[0, 0]) > 100             # noise never decodes cleanly
