"""The port's complex128 path of the locked and dense receivers (rx_locked,
rx_locked_steady, the soft stage's float64 twin, dense_soft and rx_fast)
against the JAX package's complex128 path on the CPU, at 3 channels x 5
frames.

The JAX package computes complex128 input in float64 end to end (its
CFO stays float32), and so does the port.  Tolerances: frames, metrics,
validity, decode_ok and p0 identical; the CFO within 1e-3 Hz (float32
ulps of the refinement), frac within 1e-6 samples, sync quality within
1e-9; dense soft values within DENSE_RTOL of max|soft| (float64 sums in
another order); the locked soft stage within LOCKED_RTOL of max|soft|
(its tone tables are float32 in both packages, cast up, and the two
libraries' float32 sin/cos sit an ulp apart: ~1e-8 seen); a frame start of
rx_fast one sample away only on the MSK sync apex's two-sample plateau,
where the two raw correlations agree within PLATEAU_RTOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.rx import fast as fj
from opv_tpu.rx import locked as lj
from opv_tpu.tx import modulate_frames, tx_flush_zeros
from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.ops import symbol_soft as ss
from opv_tpu_torch.rx import fast as ft
from opv_tpu_torch.rx import locked as lt

EXACT = ("frames", "metrics", "frame_valid", "decode_ok", "p0")
CLOSE = {"freq_offset": 1e-3, "frac": 1e-6, "sync_q": 1e-9}
DENSE_RTOL = 1e-12
LOCKED_RTOL = 1e-7
PLATEAU_RTOL = 1e-12
SPS = CONFIG.samples_per_symbol


@pytest.fixture(scope="module")
def c128():
    """(3, N) complex128: five BERT frames at delays 0/13/37, channel 1 at
    -350 Hz, channel 2 in AWGN (sigma 2000, numpy seed 3); the frames."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(5))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()]).astype(np.float64)
    s = iq[:, 0] + 1j * iq[:, 1]
    x = np.stack([np.concatenate([np.zeros(o), s])[:len(s)]
                  for o in (0, 13, 37)])
    x[1] *= np.exp(-2j * np.pi * 350.0 * np.arange(x.shape[1])
                   / CONFIG.sample_rate)
    rng = np.random.default_rng(3)
    x[2] += 2000.0 * (rng.standard_normal(x.shape[1])
                      + 1j * rng.standard_normal(x.shape[1]))
    return x, np.asarray(frames)


def _np(d):
    return {k: (v.numpy() if torch.is_tensor(v) else np.array(v))
            for k, v in d.items()}


def _same(got, want, exact=EXACT):
    for k in exact:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in CLOSE.items():
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg=k)


@pytest.fixture(scope="module")
def locked_both(c128):
    x, _ = c128
    want = _np(lj.rx_locked(jnp.asarray(x), n_frames=4))
    got = _np(lt.rx_locked(torch.from_numpy(x), n_frames=4))
    return got, want


def test_rx_locked_complex128_matches_jax(c128, locked_both):
    """rx_locked on complex128: JAX's frames and grid, every frame the
    transmitted one."""
    _, frames = c128
    got, want = locked_both
    _same(got, want)
    assert got["sync_q"].dtype == np.float64
    assert bool(got["frame_valid"].all())
    for c in range(3):
        np.testing.assert_array_equal(got["frames"][c], frames[:4])


def test_rx_locked_steady_complex128_matches_jax(c128, locked_both):
    """rx_locked_steady at JAX's grid and CFO: the same dict; its soft
    stage (the float64 twin of symbol_soft) within LOCKED_RTOL of JAX's
    _symbol_soft_batch."""
    x, _ = c128
    _, st = locked_both
    p0, foff, frac = (st[k] for k in ("p0", "freq_offset", "frac"))
    want = _np(lj.rx_locked_steady(jnp.asarray(x), jnp.asarray(p0),
                                   jnp.asarray(foff), 4,
                                   frac=jnp.asarray(frac)))
    got = _np(lt.rx_locked_steady(torch.from_numpy(x), torch.from_numpy(p0),
                                  torch.from_numpy(foff), 4,
                                  frac=torch.from_numpy(frac)))
    _same(got, want)
    nsym = (x.shape[1] - SPS) // SPS
    soft_j = np.asarray(lj._symbol_soft_batch(
        jnp.asarray(x), jnp.asarray(p0 % SPS), jnp.asarray(foff), nsym,
        None, jnp.asarray(frac)))
    ops = lt.soft_stage_operands(torch.from_numpy(x),
                                 torch.from_numpy(p0 % SPS),
                                 torch.from_numpy(foff), nsym,
                                 frac=torch.from_numpy(frac))
    assert [t.dtype for t in ops] == [torch.float64] * 4
    soft_t = ss.symbol_soft_reference(*ops, nsym).numpy()
    assert soft_t.dtype == soft_j.dtype == np.float64
    err = np.abs(soft_t - soft_j).max() / np.abs(soft_j).max()
    assert err <= LOCKED_RTOL, err


def test_dense_soft_complex128_matches_jax(c128):
    """dense_soft on complex128 in float64 (its tone tables too), at
    strides 1 and 2."""
    x, _ = c128
    x = x[:, :200_000]
    foff = np.array([0.0, -350.0, 20.0], np.float32)
    for stride in (1, 2):
        want = np.asarray(fj.dense_soft(jnp.asarray(x), jnp.asarray(foff),
                                        stride=stride))
        got = ft.dense_soft(torch.from_numpy(x), torch.from_numpy(foff),
                            stride=stride).numpy()
        assert got.dtype == want.dtype == np.float64
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= DENSE_RTOL, (stride, err)


def test_rx_fast_complex128_matches_jax(c128):
    """rx_fast on complex128: JAX's CFO, frames, validity and sync quality;
    starts equal but for the MSK apex plateau's ties."""
    x, frames = c128
    want = _np(fj.rx_fast(jnp.asarray(x), max_frames=6))
    got = _np(ft.rx_fast(torch.from_numpy(x), max_frames=6))
    _same(got, want, exact=("frames", "frame_valid"))
    ties = got["starts"] != want["starts"]
    np.testing.assert_array_equal(got["metrics"][~ties], want["metrics"][~ties])
    if ties.any():
        raw = ft.dense_sync(ft.dense_soft(
            torch.from_numpy(x), torch.from_numpy(want["freq_offset"])))[0]
        raw = raw.numpy()
        for c, k in zip(*np.nonzero(ties)):
            a, b = (int(v["starts"][c, k]) - 24 * SPS for v in (got, want))
            assert abs(a - b) == 1, (c, k, a, b)
            assert abs(raw[c, a] - raw[c, b]) <= PLATEAU_RTOL * abs(raw[c, a])
    assert int(got["n_decoded"]) == int(want["n_decoded"]) == 15
    assert got["sync_q"].dtype == np.float64
    for c in range(3):
        assert {bytes(f) for f in got["frames"][c][got["frame_valid"][c]]} \
            == {bytes(f) for f in frames}


def test_symbol_soft_float64_twin_contract():
    """The float64 instantiation's twin: float64 in, float64 out, raw mode
    the float64 correlation; its CUDA wrapper takes no CPU tensor and
    counts nothing."""
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.standard_normal((2, 9, 80)) * 1e4)
    kern = torch.from_numpy(rng.standard_normal((2, 80, 8)))
    resc = torch.ones(2, dtype=torch.float64)
    phi = torch.from_numpy(rng.standard_normal((2, 2, 2)))
    soft = ss.symbol_soft_reference(rows, kern, resc, phi, 8)
    ab = ss.symbol_soft_reference(rows, kern, resc, phi, 8, raw=True)
    assert soft.dtype == ab.dtype == torch.float64
    assert soft.shape == (2, 8) and ab.shape == (2, 9, 8)
    np.testing.assert_allclose(
        ab.numpy(), np.einsum("cst,cto->cso", rows.numpy(), kern.numpy()),
        rtol=1e-12, atol=1e-9)
    n0 = dict(ss.symbol_soft_cuda.launches)
    with pytest.raises(ValueError):
        ss.symbol_soft_cuda(rows, kern, resc, phi, 8)
    assert ss.symbol_soft_cuda.launches == n0 and "float64" in n0
    assert ss.moved_bytes(rows, kern, resc, phi, 8) == \
        (rows.numel() + kern.numel() + resc.numel() + phi.numel()) * 8 + 2 * 8 * 8
