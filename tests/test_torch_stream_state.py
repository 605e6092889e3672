"""Checkpoints of the port's streaming engine: saved by one package and
loaded by the other, the stream continues tuple-identical to an
uninterrupted run; mid-pend, cross-dtype and legacy buffer layouts; and
the engine's construction and feed contract (device, the modes, invalid
and unported options).

Tolerance: identical tuple streams — channel, frame bytes, Viterbi metric
and absolute position equal, sync quality within 1e-4."""

import numpy as np
import pytest
import torch

import opv_tpu.stream as sj
import opv_tpu_torch.stream as st
from stream_scenarios import SPF, assert_same_stream, run, signal


def _port(channels, **kw):
    return st.LockedStreamDemodulator(channels, device="cpu", **kw)


@pytest.fixture(scope="module")
def two_channel():
    """Ten frames on two channels (channel 1 phase-rotated) and the JAX
    engine's uninterrupted tuples."""
    s, _ = signal(10)
    x = np.stack([s, s * np.exp(1j * 0.3).astype(np.complex64)])
    return x, run(sj.LockedStreamDemodulator(2, block_frames=4), x)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("cut", [6 * SPF + 1000, 5 * SPF + 1013])
def test_checkpoint_crosses_packages(tmp_path, two_channel, direction, cut):
    """A state_tree() saved by one package's save_state loads into the
    other package's engine through its load_state; the rest of the stream
    continues as one uninterrupted run (the second cut leaves a sub-row
    tail pending)."""
    x, ref = two_channel
    first = (sj.LockedStreamDemodulator(2, block_frames=4)
             if direction == "jax_to_port" else _port(2, block_frames=4))
    second = (_port(2, block_frames=4) if direction == "jax_to_port"
              else sj.LockedStreamDemodulator(2, block_frames=4))
    save = sj.save_state if direction == "jax_to_port" else st.save_state
    load = st.load_state if direction == "jax_to_port" else sj.load_state
    out = list(first.feed(x[:, :cut]))
    tree = first.state_tree()
    assert int(tree["pend_len"]) == cut % 40
    save(str(tmp_path / "ck"), tree)
    second.load_state_tree(load(str(tmp_path / "ck"), second.state_tree()))
    out += second.feed(x[:, cut:]) + second.flush()
    assert_same_stream(out, ref)
    assert second.decoded == 20


def test_state_layout_matches_jax():
    """Same keys, and leaves of the same shapes and kinds, so the sorted
    leaf order of either package's .npz is the other's."""
    tj = sj.LockedStreamDemodulator(2, block_frames=4).state_tree()
    tt = _port(2, block_frames=4).state_tree()
    assert sorted(tt) == sorted(tj)
    for k in tj:
        a = np.asarray(tj[k])
        b = tt[k].numpy() if isinstance(tt[k], torch.Tensor) else np.asarray(tt[k])
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k


@pytest.mark.parametrize("dt_a,dt_b", [("int8", "float32"), ("float32", "int8"),
                                       ("int8", "int8"), ("bfloat16", "int8")])
def test_checkpoint_cross_dtype_adoption(tmp_path, dt_a, dt_b):
    """int8 buffers checkpoint at the quantized scale; loading across
    buffer dtypes rescales between the domains and keeps decoding."""
    s, frames = signal(8)
    x = s[None, :]
    sd = _port(1, block_frames=2, dtype=dt_a, agc=False)
    cut = 3 * SPF + 17_003                    # mid-window, mid-row
    out = list(sd.feed(x[:, :cut]))
    st.save_state(str(tmp_path / "ck"), sd.state_tree())
    sd2 = _port(1, block_frames=2, dtype=dt_b, agc=False)
    sd2.load_state_tree(st.load_state(str(tmp_path / "ck"), sd.state_tree()))
    out += sd2.feed(x[:, cut:]) + sd2.flush()
    assert [r[1] for r in out] == [bytes(f) for f in frames]


def test_legacy_checkpoint_layouts_adopt():
    """(C, window, 2) pair buffers and (C, window) complex buffers with a
    sub-row count load and continue as one uninterrupted run."""
    s, _ = signal(8)
    x = s[None, :]
    cut = 4 * SPF + 977
    sd = _port(1, block_frames=4)
    out_a = sd.feed(x[:, :cut])
    tree = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.state_tree().items()}
    ref = run(_port(1, block_frames=4), x)
    pairs = tree["buf"].reshape(1, -1, 2).copy()
    count, plen = int(tree["count"]), int(tree["pend_len"])
    pairs[:, count:count + plen] = tree["pend"][:, :plen]
    base = {k: v for k, v in tree.items()
            if k not in ("buf", "count", "pend", "pend_len")}
    for buf in (pairs, (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)):
        sd2 = _port(1, block_frames=4)
        sd2.load_state_tree(dict(base, buf=buf, count=np.int64(count + plen)))
        assert out_a + sd2.feed(x[:, cut:]) + sd2.flush() == ref


def test_tensor_and_numpy_feeds_agree():
    """CPU tensors, numpy arrays and int16 pairs feed the same stream; the
    engine never keeps a view of the caller's array."""
    s, frames = signal(3)
    x = np.concatenate([np.zeros(333, np.complex64), s])[None, :]
    want = run(_port(1), x, chunk=50_001)
    sd = _port(1)
    got = []
    for off in range(0, x.shape[1], 50_001):
        chunk = x[:, off:off + 50_001].copy()
        got += sd.feed(torch.from_numpy(chunk))
        chunk[:] = 0                          # the caller reuses its buffer
    assert got + sd.flush() == want
    assert [r[1] for r in want] == [bytes(f) for f in frames]


def test_options_not_ported_raise():
    """The channel-sharded engine is not ported: mesh= raises, naming its
    roadmap item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(2, mesh=object())


@pytest.fixture(scope="module")
def four_frames():
    """Four frames 311 samples into the stream, (1, N), and the
    synchronous float32 engine's tuples at block_frames 1."""
    s, frames = signal(4)
    x = np.concatenate([np.zeros(311, np.complex64), s])[None]
    want = run(_port(1, block_frames=1), x, chunk=50_001)
    assert [r[1] for r in want] == [bytes(f) for f in frames]
    return x, want


@pytest.mark.parametrize("kw", [dict(pipeline=True), dict(eager=True),
                                dict(hunt_stride=2), dict(dtype="int8")],
                         ids=["pipeline", "eager", "hunt_stride2", "int8_agc"])
def test_modes_run(four_frames, kw):
    """Each mode of the JAX engine constructs with its defaults (int8 with
    AGC on) and decodes a clean stream as the synchronous float32 engine
    does."""
    x, want = four_frames
    sd = _port(1, block_frames=1, **kw)
    assert_same_stream(run(sd, x, chunk=50_001), want)
    if "dtype" in kw:                     # AGC primed on the first feed:
        assert sd._agc and sd._agc_primed   # a full-scale clean stream
        assert sd._scale_np[0] == 129.0     # adopts INT8_SCALE exactly


@pytest.mark.parametrize("kw,match", [
    (dict(eager=True, pipeline=True), "exclusive"),
    (dict(hunt_stride=3), "divide")])
def test_invalid_modes_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _port(1, **kw)


def test_engine_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert st.LockedStreamDemodulator(1)._buf.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        st.LockedStreamDemodulator(1)
    sd = _port(1, dtype="auto")
    assert sd.dtype == torch.float32 and sd._buf.device.type == "cpu"
    with pytest.raises(ValueError, match="dtype"):
        _port(1, dtype="float16")
