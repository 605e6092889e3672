"""The port's StreamingDemodulator (opv_tpu_torch/stream/chunked.py) on the
CPU: the nine golden checks of tests/test_streaming.py (the reference
binary's streaming output, byte for byte), slicing invariance, frames
across chunk boundaries, the JAX package's tuples and sync events, and
checkpoints saved by either package and resumed by the other.

Frames, metrics, symbol indices and event codes/indices/counters must be
equal to opv_tpu's; sync quality and the events' norm within Q_TOL and
their raw correlation within RAW_RTOL (float64 sums of the soft values,
which the two packages round differently at the ~1e-15 level)."""

import numpy as np
import pytest
import torch

from opv_tpu.config import CONFIG
from opv_tpu.stream import StreamingDemodulator as StreamJ
from opv_tpu.stream import load_state as load_j
from opv_tpu.stream import save_state as save_j
from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
from opv_tpu_torch.stream import StreamingDemodulator, load_state, save_state
from opv_tpu_torch.tx.modulator import modulate_frames, tx_flush_zeros

Q_TOL = 1e-12
RAW_RTOL = 1e-12


def _load_iq(golden_dir, name):
    raw = np.fromfile(golden_dir / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    return raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)


def _golden(golden_dir, name):
    data = (golden_dir / name).read_bytes()
    return [data[i:i + 134] for i in range(0, len(data), 134)]


def _run(x, **kw):
    sd = StreamingDemodulator(device="cpu", **kw)
    return sd, sd.feed(x) + sd.flush()


def _same(got, want):
    assert [(t[0], t[1], t[3]) for t in got] == [(t[0], t[1], t[3]) for t in want]
    assert max((abs(a[2] - b[2]) for a, b in zip(got, want)), default=0) <= Q_TOL


@pytest.mark.parametrize("name,gold,opts", [
    ("bert3", "bert3.frames", {}),
    ("cfo500", "cfo500.frames", {}),
    ("awgn10", "awgn10.frames", {}),
    ("awgn7", "awgn7.frames", {}),
    ("awgn8", "awgn8.frames", {}),
    ("dropout", "dropout.frames", {}),
    ("drift", "drift.frames", {}),
    ("cfo500", "cfo500_a01.frames", {"afc_alpha": 0.01}),
    ("cfo500", "cfo500_o500.frames", {"init_offset": 500.0}),
])
def test_golden_stream_bit_exact(golden_dir, name, gold, opts):
    """The reference's streaming frames, including which frames it loses
    (awgn7/8: 11 of 12) and every residual bit error; the tracker LOCKED
    at the end; drift pulls the timing loop."""
    sd, res = _run(_load_iq(golden_dir, name), **opts)
    assert [r[0] for r in res] == _golden(golden_dir, gold)
    assert sd.decoded == len(res) and sd.sync_state == "LOCKED"
    if name == "bert3":
        assert sd.perfect == 3 and all(r[1] == 0 for r in res)
        assert sd.est_offset == pytest.approx(1430.0)
    if name == "drift":
        assert sd.timing_freq != 0.0


def test_slicing_invariance(golden_dir):
    """Odd-sized feeds give the tuples of one whole feed."""
    x = _load_iq(golden_dir, "bert3")
    _, whole = _run(x)
    rng = np.random.default_rng(0)
    sd = StreamingDemodulator(device="cpu")
    res, off = [], 0
    while off < len(x):
        n = int(rng.integers(1, 50_000))
        res += sd.feed(x[off:off + n])
        off += n
    assert res + sd.flush() == whole


def test_frames_span_chunk_boundaries():
    """10 frames of the port's TX: every frame straddling a chunk seam
    decodes (history + state carry), fed as a CPU tensor."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(10))
    iq, _ = modulate_frames(encode_frame(torch.from_numpy(frames)))
    iq = torch.cat([iq, tx_flush_zeros()]).to(torch.float64)
    _, res = _run(torch.complex(iq[:, 0], iq[:, 1]))
    assert [r[0] for r in res] == [bytes(f) for f in frames]
    assert all(r[1] == 0 for r in res)


def test_tuples_and_events_match_jax(golden_dir):
    """cfo500 with the event callback: the same tuples and the same
    transition events (index, code, misses, frames; norm and raw within
    tolerance) as opv_tpu's StreamingDemodulator; the same counters."""
    x = _load_iq(golden_dir, "cfo500")
    ev_t, ev_j = [], []
    sd, got = _run(x, on_event=lambda *a: ev_t.append(a))
    sj = StreamJ(on_event=lambda *a: ev_j.append(a))
    want = sj.feed(x) + sj.flush()
    _same(got, want)
    assert [(e[0], e[1], e[4], e[5]) for e in ev_t] == \
        [(e[0], e[1], e[4], e[5]) for e in ev_j]
    for a, b in zip(ev_t, ev_j):
        assert abs(a[2] - b[2]) <= Q_TOL
        assert abs(a[3] - b[3]) <= RAW_RTOL * max(1.0, abs(b[3]))
    assert (sd.total_samples, sd.total_symbols, sd.decoded, sd.perfect) == \
        (sj.total_samples, sj.total_symbols, sj.decoded, sj.perfect)
    assert sd.sync_state == sj.sync_state
    assert sd.freq_offset == pytest.approx(sj.freq_offset, abs=1e-6)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port",
                                       "port_to_port"])
def test_checkpoint_resume(golden_dir, tmp_path, direction):
    """A stream split across two demodulators via save_state/load_state,
    mid-chunk: the second continues exactly where the first stopped, in
    either package (the JAX layout: lstate, tstate, hist, buf, first,
    est_offset, counters)."""
    x = _load_iq(golden_dir, "cfo500")
    half = 3 * CONFIG.chunk_samples + 12_345
    _, whole = _run(x)
    path = str(tmp_path / "st.npz")
    if direction == "jax_to_port":
        first = StreamJ()
        res1 = first.feed(x[:half])
        save_j(path, first.state_tree())
        second = StreamingDemodulator(device="cpu")
        second.restore(load_state(path, second.state_tree()))
    else:
        first = StreamingDemodulator(device="cpu")
        res1 = first.feed(x[:half])
        save_state(path, first.state_tree())
        if direction == "port_to_jax":
            second = StreamJ()
            like = second.state_tree() | {"buf": np.zeros(1, np.complex128)}
            second.restore(load_j(path, like))
        else:
            second = StreamingDemodulator(device="cpu")
            second.restore(load_state(path, second.state_tree()))
    res = res1 + second.feed(x[half:]) + second.flush()
    _same(res, whole)
    assert second.decoded == len(whole)
    if direction == "port_to_port":
        assert res == whole


def test_state_tree_layout_matches_jax():
    """The same keys, leaf count, leaf shapes and dtypes as opv_tpu's."""
    import jax
    from opv_tpu_torch.stream.state import _paths
    sd, sj = StreamingDemodulator(device="cpu"), StreamJ()
    t_t, t_j = sd.state_tree(), sj.state_tree()
    assert sorted(t_t) == sorted(t_j)
    leaves_j = jax.tree.leaves(t_j)
    paths = _paths(t_t)
    assert len(paths) == len(leaves_j)
    for p, b in zip(paths, leaves_j):
        a = t_t
        for k in p:
            a = a[k]
        a = np.asarray(a)
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype, p


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        StreamingDemodulator()


def test_float32_names_item_11b():
    """dtype="float32" (item 11b) builds a float32 receiver; another dtype
    is refused by name."""
    sd = StreamingDemodulator(dtype="float32", device="cpu")
    assert sd.hist.dtype == sd.lstate.mu.dtype == sd.tstate.sync_q.dtype \
        == torch.float32
    assert sd.feed(np.zeros(100, np.complex64)) == [] and sd.flush() == []
    with pytest.raises(ValueError, match="bfloat16"):
        StreamingDemodulator(dtype="bfloat16", device="cpu")
