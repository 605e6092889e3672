"""The port's float32 tracking receiver (ops/track_symbols.py and
ops/sync_scan.py over float32, rx_batch, StreamingDemodulator and
MultiChannelTrackingDemodulator at dtype="float32") against the JAX
package's float32 mode on the CPU.

JAX runs with x64 on (tests/conftest.py), so every JAX input here is made
complex64 / float32 explicitly.  The CFO grid argmaxes a curve flat to
~1e-6, so the two packages' float32 estimates may pick different bins
(1470 against 1440 Hz on bert3): wherever soft values, loop state or
metrics are compared, the offset is pinned.

Tolerances (float32 sums in another order than XLA's, and the host's and
XLA's float32 sin/cos/atan2 an ulp apart; the loops are stable, so the
trajectories stay close): soft within SOFT_RTOL of max|soft|, each state
field within STATE_RTOL x max(1, |JAX's|) (phases modulo 2 pi), sync
quality within Q_TOL; n_sym, sym_valid, samples_used, frames, metrics and
symbol indices equal.  The sync machine's twin only adds, compares and
copies, so T2[float32] is held bit for bit.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.config import CONFIG
from opv_tpu.rx import coherent as coherent_j
from opv_tpu.rx import demod as demod_j
from opv_tpu.rx import sync as sync_j
from opv_tpu.rx.pipeline import rx_batch as rx_batch_j
from opv_tpu.stream import StreamingDemodulator as StreamJ
from opv_tpu.stream.tracking import MultiChannelTrackingDemodulator as TrackJ
from opv_tpu_torch.ops import sync_scan as sc
from opv_tpu_torch.ops import track_symbols as ts
from opv_tpu_torch.rx import demod as demod_t
from opv_tpu_torch.rx import sync as sync_t
from opv_tpu_torch.rx.pipeline import rx_batch
from opv_tpu_torch.stream import (MultiChannelTrackingDemodulator,
                                  StreamingDemodulator)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import soft_stress, sync_stress  # noqa: E402

SOFT_RTOL = 2e-5
STATE_RTOL = 1e-4
Q_TOL = 1e-5
#: the coherent loop's soft values over COHERENT_SYMBOLS symbols, relative
#: to max|soft| (float32 rounding of the 40-term sums grows in the loop)
COHERENT_RTOL = 1e-4
COHERENT_SYMBOLS = 320
CAP = 16_000          # ~400 symbols a call
#: the offsets the JAX package's float32 grid picks (pinned in both)
OFFSET = {"bert3": 1440.0, "cfo500": 1530.0, "awgn8": 1530.0}


def _load(golden_dir, name, n=None):
    raw = np.fromfile(golden_dir / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    s = raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)
    return s[:n]


def _golden(golden_dir, name):
    data = (golden_dir / name).read_bytes()
    return [data[i:i + 134] for i in range(0, len(data), 134)]


_demod_j = jax.jit(demod_j.demodulate_block)


def _close_state(st_t, st_j, c):
    for name, a, b in zip(demod_t.LoopState._fields, st_t, st_j):
        a, b = complex(a[c]), complex(np.asarray(b))
        d = a - b
        if name.startswith("phase"):
            d = (d.real + np.pi) % (2 * np.pi) - np.pi
        assert abs(d) <= STATE_RTOL * max(1.0, abs(b)), (name, c, a, b)


@pytest.mark.parametrize("names", [("bert3",), ("bert3", "cfo500", "awgn8")],
                         ids=["C=1", "C=3"])
def test_track_symbols_f32_matches_jax(golden_dir, names):
    """Two calls per channel, the second from the first's state and
    leftover (the first partial, n_valid < CAP): the twin of
    track_symbols[float32] against demodulate_block at float32."""
    x = np.stack([_load(golden_dir, n, 3 * CAP) for n in names]
                 ).astype(np.complex64)
    c = len(names)
    st_t = demod_t.loop_state_init(torch.tensor([OFFSET[n] for n in names]),
                                   channels=c, dtype=torch.float32)
    st_j = [demod_j.loop_state_init(OFFSET[n], dtype=jnp.float32)
            for n in names]
    start, nv = np.zeros(c, np.int64), np.full(c, CAP - 3_001)
    for _ in range(2):
        buf = np.stack([x[i, start[i]:start[i] + CAP] for i in range(c)])
        soft_t, valid_t, st_t, used_t = demod_t.demodulate_block(
            torch.from_numpy(buf), torch.from_numpy(nv), st_t)
        assert soft_t.dtype == torch.float32
        assert st_t.prev_c1.dtype == torch.complex64
        for i in range(c):
            soft_j, valid_j, st_j[i], used_j = _demod_j(
                jnp.asarray(buf[i]), jnp.int32(nv[i]), st_j[i])
            soft_j = np.asarray(soft_j)
            assert soft_j.dtype == np.float32
            assert np.array_equal(valid_t[i].numpy(), np.asarray(valid_j))
            assert int(used_t[i]) == int(used_j)
            err = np.abs(soft_t[i].numpy() - soft_j).max()
            assert err <= SOFT_RTOL * np.abs(soft_j).max(), (names[i], err)
            _close_state(st_t, st_j[i], i)
            start[i] += int(used_j)
        nv[:] = CAP


def test_track_symbols_f32_twin_takes_odd_rows():
    """An odd capacity and a view at an odd storage offset (the kernel's
    wrapper pads such rows; the twin reads them in place): each channel as
    its own one-channel call; the float64 state is refused."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 4_001)) + 1j * rng.standard_normal(
        (3, 4_001))).astype(np.complex64) * 3000
    buf = torch.zeros(3 * 4_001 + 1, dtype=torch.complex64)
    xv = buf[1:].view(3, 4_001).copy_(torch.from_numpy(x))
    st = demod_t.pack_state(demod_t.loop_state_init(
        200.0, channels=3, dtype=torch.float32))
    nv = torch.tensor([4_001, 3_999, 100], dtype=torch.int32)
    maxs = demod_t.max_symbols(4_001)
    got = ts.track_symbols_reference(xv, nv, st, 0.001, maxs)
    for c in range(3):
        one = ts.track_symbols_reference(xv[c:c + 1].clone(), nv[c:c + 1],
                                         st[c:c + 1], 0.001, maxs)
        for a, b in zip(got, one):
            assert torch.equal(a[c], b[0])
    assert got[1].sum(1).tolist()[2] == 2 and got[0].dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        ts.track_symbols_reference(xv, nv, st.double(), 0.001, maxs)


def _state_j(row, q):
    state, sss, misses, coll, total, frames = (int(v) for v in row)
    return sync_j.SyncTrackerState(
        state=jnp.int32(state), sss=jnp.int32(sss), misses=jnp.int32(misses),
        sync_q=jnp.float32(q), collecting=jnp.bool_(coll),
        total=jnp.int32(total), frames=jnp.int32(frames))


def _bits(t):
    t = np.atleast_1d(np.asarray(t))
    return t.view(np.uint8) if t.dtype.kind == "f" else t


@pytest.mark.parametrize("route", ["GivenSync", "SoftSync"])
def test_sync_scan_f32_bit_identical_to_jax(route):
    """The machine's twin in float32 against JAX's sync_scan (GivenSync:
    sync_stress's raw/norm, with norms exactly at the thresholds once
    rounded to float32: 0.7 passes the locked check as JAX rounds it) and
    sync_correlate + sync_scan (SoftSync: soft_stress's stream), every
    output and the carry bit for bit."""
    cpu = torch.device("cpu")
    if route == "GivenSync":
        raw, norm, valid, ints, q = sync_stress(12, 2_500, cpu)
        # channels 5 and 11 LOCKED, every norm at the locked threshold
        norm[5::6] = CONFIG.sync_locked_norm_thresh
        ints[5::6, 1] = 1_000
        raw, norm = raw.float(), norm.float()
        got = sc.sync_scan_reference(raw, norm, valid, ints, q.float())
    else:
        ext, valid, ints, q = soft_stress(12, 2_500, cpu)
        ext = ext.float()
        got = sc.sync_correlate_scan_reference(ext, valid, ints, q.float())
        raw, norm = got[7], got[8]
    assert got[3].dtype == torch.float32
    for c in range(12):
        if route == "GivenSync":
            rj, nj = jnp.asarray(raw[c].numpy()), jnp.asarray(norm[c].numpy())
        else:
            rj, nj = sync_j.sync_correlate(jnp.asarray(ext[c].numpy()))
            assert np.array_equal(_bits(rj), _bits(raw[c].numpy()))
            assert np.array_equal(_bits(nj), _bits(norm[c].numpy()))
        want = sync_j.sync_scan(_state_j(ints[c].tolist(), 0.0), rj, nj,
                                jnp.asarray(valid[c].numpy()))
        st = [want[0].state, want[0].sss, want[0].misses,
              want[0].collecting, want[0].total, want[0].frames]
        assert got[0][c].tolist() == [int(v) for v in st]
        assert np.array_equal(_bits(got[1][c].numpy()),
                              _bits(np.float32(want[0].sync_q)))
        for k, (a, b) in enumerate(zip(got[2:7], want[1:])):
            assert np.array_equal(_bits(a[c].numpy()), _bits(b)), (c, k)
    # the thresholds really were float32's: some norm equal to f32(0.7)
    # passed a locked check (an EV_SYNC_OK), which a double compare refuses
    if route == "GivenSync":
        at = (norm == np.float32(CONFIG.sync_locked_norm_thresh)) \
            & (got[4] == sc.EV_SYNC_OK)
        assert bool(at.any())


def test_sync_tracker_init_dtype():
    st = sync_t.sync_tracker_init(3, dtype=torch.float32)
    assert st.sync_q.dtype == torch.float32 and st.state.dtype == torch.int32
    assert sync_t.sync_tracker_init().sync_q.dtype == torch.float64


@pytest.mark.parametrize("name,gold", [("bert3", "bert3.frames"),
                                       ("awgn8", None),
                                       ("dropout", "dropout.frames")])
def test_rx_batch_f32_matches_jax(golden_dir, name, gold):
    """rx_batch(dtype="float32"): frames, metrics and t_idx equal JAX's
    float32 batch run at JAX's offset; bert3 and dropout the reference's
    frames (awgn8.frames is a streaming capture's: the batch mode reads
    other bits in both packages, float64 too); on bert3 also at the
    port's own estimate, another bin of the flat grid."""
    s = _load(golden_dir, name)
    want = rx_batch_j(s, dtype="float32")
    got = rx_batch(s, dtype="float32", device="cpu",
                   init_offset=float(want["est_offset"]))
    for k in ("frames", "metrics", "t_idx"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("n_symbols", "samples_used", "tracker_state", "decoded"):
        assert got[k] == want[k], k
    assert np.abs(got["sync_q"] - want["sync_q"]).max(initial=0) <= Q_TOL
    assert got["sync_q"].dtype == got["freq_offset"].dtype == np.float32
    if gold:
        assert [bytes(f) for f in got["frames"]] == _golden(golden_dir, gold)
    if name == "bert3":
        # its own CFO estimate on complex64 (1470 Hz here, JAX's 1440)
        # decodes the same frames at the same symbols
        own = rx_batch(s, dtype="float32", device="cpu")
        assert float(own["est_offset"]) != float(want["est_offset"])
        assert np.array_equal(own["frames"], want["frames"])
        assert np.array_equal(own["t_idx"], want["t_idx"])


@pytest.mark.parametrize("name", ["bert3", "awgn10"])
def test_streaming_f32_matches_jax(golden_dir, name):
    """StreamingDemodulator(dtype="float32") at JAX's offset: JAX's tuples
    and transition events (symbol, code, misses, frames equal; norm within
    Q_TOL), the reference's frames, the same counters."""
    s = _load(golden_dir, name)
    ev_t, ev_j = [], []
    sj = StreamJ(dtype="float32", on_event=lambda *a: ev_j.append(a))
    want = sj.feed(s) + sj.flush()
    sd = StreamingDemodulator(dtype="float32", device="cpu",
                              init_offset=sj.est_offset,
                              on_event=lambda *a: ev_t.append(a))
    got = sd.feed(s) + sd.flush()
    assert [(t[0], t[1], t[3]) for t in got] == \
        [(t[0], t[1], t[3]) for t in want]
    assert max(abs(a[2] - b[2]) for a, b in zip(got, want)) <= Q_TOL
    assert [t[0] for t in got] == _golden(golden_dir, f"{name}.frames")
    assert [(e[0], e[1], e[4], e[5]) for e in ev_t] == \
        [(e[0], e[1], e[4], e[5]) for e in ev_j]
    assert max(abs(a[2] - b[2]) for a, b in zip(ev_t, ev_j)) <= Q_TOL
    assert (sd.total_samples, sd.total_symbols, sd.decoded, sd.perfect) == \
        (sj.total_samples, sj.total_symbols, sj.decoded, sj.perfect)
    assert sd.sync_state == sj.sync_state
    assert sd.lstate.mu.dtype == sd.hist.dtype == torch.float32


def test_multichannel_tracking_f32_matches_jax(golden_dir):
    """MultiChannelTrackingDemodulator(3, dtype="float32") at one pinned
    offset: JAX's tuples, and each channel its own single-channel run."""
    names = ("bert3", "cfo500", "awgn8")
    caps = [_load(golden_dir, n) for n in names]
    n = min(len(s) for s in caps)
    x = np.stack([s[:n] for s in caps])
    mj = TrackJ(channels=3, init_offset=1500.0, dtype="float32")
    want = mj.feed(x) + mj.flush()
    mc = MultiChannelTrackingDemodulator(3, init_offset=1500.0,
                                         dtype="float32", device="cpu")
    got = mc.feed(x) + mc.flush()
    assert [(r[0], r[1], r[2], r[4]) for r in got] == \
        [(r[0], r[1], r[2], r[4]) for r in want]
    assert max(abs(a[3] - b[3]) for a, b in zip(got, want)) <= Q_TOL
    assert np.array_equal(mc.decoded, mj.decoded)
    sd = StreamingDemodulator(dtype="float32", device="cpu",
                              init_offset=1500.0)
    single = sd.feed(x[2]) + sd.flush()
    assert [r[1:] for r in got if r[0] == 2] == single


def test_coherent_rx_batch_f32_matches_jax(golden_dir):
    """rx_batch(coherent=True, dtype="float32"): the soft stream over its
    first COHERENT_SYMBOLS symbols within COHERENT_RTOL of JAX's float32
    Costas loop from the same offset."""
    s = _load(golden_dir, "bert3", COHERENT_SYMBOLS * 40 + 17)
    out = rx_batch(s, coherent=True, dtype="float32", init_offset=1430.0,
                   device="cpu")
    a, b = coherent_j.pll_gains(50.0)
    soft_j, _ = coherent_j.demodulate_coherent(
        jnp.asarray(s.astype(np.complex64)),
        coherent_j.coherent_state_init(1430.0, dtype=jnp.float32),
        CONFIG.afc_alpha, a, b)
    soft_j = np.asarray(soft_j)
    assert out["soft"].dtype == soft_j.dtype == np.float32
    assert out["soft"].shape == soft_j.shape == (COHERENT_SYMBOLS,)
    err = np.abs(out["soft"] - soft_j).max() / np.abs(soft_j).max()
    assert err <= COHERENT_RTOL, err
