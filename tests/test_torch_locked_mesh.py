"""The port's channel-sharded engine and wideband receiver (mesh= of
opv_tpu_torch/stream/locked.py and stream/wideband.py) on the CPU:
tests/test_locked_stream.py's TestShardedLocked cases, eager serving and
the strided hunt under a mesh, and the wideband receiver at K = 8 on
'ch'=8 and 4.

Each sharded run is held to the port's own unsharded engine on the same
feed, tuple for tuple and exactly (sync quality too): every shard computes
its channels as the whole bank computes them, and the host lifecycle is
one code path.  The unsharded engine is held to the JAX package's by the
earlier test files; one clean 8-channel case here is also held directly to
the JAX package's sharded engine on its eight virtual CPU devices
(channel, bytes, metric and position identical, sync quality within
Q_TOL).  The port's meshes name the CPU several times."""

import pathlib
import sys

import numpy as np
import pytest
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_channelizer import msk_wideband, synthesize_wideband  # noqa: E402

from opv_tpu.core import build_bert_frame, encode_frame  # noqa: E402
from opv_tpu.parallel.mesh import make_mesh as make_mesh_j  # noqa: E402
from opv_tpu.stream.locked import LockedStreamDemodulator as LockedJ  # noqa: E402
from opv_tpu.tx import modulate_frames, tx_flush_zeros  # noqa: E402
from opv_tpu_torch.config import CONFIG  # noqa: E402
from opv_tpu_torch.parallel import make_mesh  # noqa: E402
from opv_tpu_torch.stream import (LockedStreamDemodulator, WidebandReceiver,  # noqa: E402
                                  load_state, save_state)

SPF = CONFIG.samples_per_frame
Q_TOL = 1e-4


def _signal(n_frames, start=0):
    frames = build_bert_frame("W5NYV", frame_num=start + np.arange(n_frames))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64), np.asarray(frames)


def _staggered(s, channels, pad=8000):
    sig = np.zeros((channels, len(s) + pad), np.complex64)
    for c in range(channels):
        sig[c, c * 997: c * 997 + len(s)] = s
    return sig


def _run(sd, x, chunk=None):
    out = []
    if chunk is None:
        out.extend(sd.feed(x))
    else:
        for off in range(0, x.shape[1], chunk):
            out.extend(sd.feed(x[:, off:off + chunk]))
    return out + sd.flush()


def mesh(n):
    return make_mesh({"ch": n}, devices=["cpu"] * n)


def engine(channels, **kw):
    kw.setdefault("device", "cpu")
    return LockedStreamDemodulator(channels, **kw)


@pytest.fixture(scope="module")
def clean8():
    """Five frames on 8 staggered channels and the unsharded engine's
    tuples at block_frames 2, fed in 123,457-sample chunks."""
    s, frames = _signal(5)
    x = _staggered(s, 8)
    ref = _run(engine(8, block_frames=2), x, chunk=123_457)
    assert len(ref) == 40 and {r[1] for r in ref} == {bytes(f) for f in frames}
    return x, ref


def test_clean_8ch_tuple_identical_and_buffer_sharded(clean8):
    """One channel per shard: the unsharded engine's tuples, and the
    window is one (1, window/40, 80) tensor per shard.  The JAX package's
    sharded engine on the same feed emits the same tuples."""
    x, ref = clean8
    sd = engine(8, block_frames=2, mesh=mesh(8))
    assert _run(sd, x, chunk=123_457) == ref
    assert [tuple(p.shape) for p in sd._buf.parts] == \
        [(1, sd.window // 40, 80)] * 8
    assert sd.decoded == 40
    sj = LockedJ(8, block_frames=2, mesh=make_mesh_j({"ch": 8}))
    want = _run(sj, x, chunk=123_457)
    assert [(t[0], t[1], t[2], t[4]) for t in ref] == \
        [(t[0], t[1], t[2], t[4]) for t in want]
    assert max(abs(a[3] - b[3]) for a, b in zip(ref, want)) <= Q_TOL


def test_mixed_lock_states_reacquire_cfo():
    """Half the channels drop lock into a noise gap and re-hunt a +500 Hz
    burst while the others stay locked: the sharded re-acquire (keep mask,
    summed count) gives the unsharded lifecycle's tuples and counters."""
    rng = np.random.default_rng(3)
    s1, _ = _signal(3)
    s2, _ = _signal(3, start=100)
    gap = (rng.standard_normal(6 * SPF) +
           1j * rng.standard_normal(6 * SPF)).astype(np.complex64) * 50.0
    t = np.arange(len(s2))
    s2c = (s2 * np.exp(2j * np.pi * 500.0 * t / CONFIG.sample_rate)
           ).astype(np.complex64)
    bursty = np.concatenate([s1, gap, np.zeros(23, np.complex64), s2c])
    reps = -(-len(bursty) // len(s1))
    steady = np.concatenate([s1] * reps)[:len(bursty)]
    x = np.stack([bursty if c % 2 else steady for c in range(4)])
    ref_sd = engine(4, block_frames=4)
    ref = _run(ref_sd, x, chunk=70_001)
    sd = engine(4, block_frames=4, mesh=mesh(4))
    assert _run(sd, x, chunk=70_001) == ref
    assert sd.reacquisitions == ref_sd.reacquisitions >= 1
    assert sd.decoded == ref_sd.decoded


def test_pipelined_sharded_equals_synchronous(clean8):
    """pipeline=True composes with mesh=, two channels per shard: the
    chained p0/freq_offset stay on their shards, mispredictions relaunch
    every shard."""
    x, ref = clean8
    sd = engine(8, block_frames=2, mesh=mesh(4), pipeline=True)
    assert _run(sd, x, chunk=123_457) == ref
    assert [tuple(p.shape) for p in sd._buf.parts] == \
        [(2, sd.window // 40, 80)] * 4


def test_int8_agc_sharded():
    """int8 rows and per-channel AGC under the mesh: the statistics, the
    step adoption and the requant of the buffered window run per shard;
    the unsharded int8 + AGC engine's tuples, a different step on every
    channel."""
    s, _ = _signal(4)
    x = _staggered(s, 4)
    x *= (1.0 / (1 << np.arange(4)))[:, None]
    ref = _run(engine(4, block_frames=2, dtype="int8"), x, chunk=SPF)
    sd = engine(4, block_frames=2, dtype="int8", mesh=mesh(4))
    assert _run(sd, x, chunk=SPF) == ref
    assert len({float(v) for v in sd._scale_np}) == 4


def test_checkpoint_crosses_placements(clean8, tmp_path):
    """A sharded engine's checkpoint restores into an unsharded engine,
    and an unsharded one's into a sharded engine: the state tree is
    placement-agnostic."""
    x, ref = clean8
    cut = 2 * SPF + 11_003
    sd = engine(8, block_frames=2, mesh=mesh(4))
    out = list(sd.feed(x[:, :cut]))
    save_state(str(tmp_path / "ck"), sd.state_tree())
    sd2 = engine(8, block_frames=2)
    sd2.load_state_tree(load_state(str(tmp_path / "ck"), sd2.state_tree()))
    assert _run(sd2, x[:, cut:]) == ref[len(out):]

    sd3 = engine(8, block_frames=2)
    out3 = list(sd3.feed(x[:, :cut]))
    save_state(str(tmp_path / "ck2"), sd3.state_tree())
    sd4 = engine(8, block_frames=2, mesh=mesh(2))
    sd4.load_state_tree(load_state(str(tmp_path / "ck2"), sd4.state_tree()))
    assert out3 + _run(sd4, x[:, cut:]) == ref


def test_geometry_validation():
    with pytest.raises(ValueError, match="divisible"):
        engine(6, mesh=mesh(4))
    with pytest.raises(ValueError, match="'ch' axis"):
        engine(8, mesh=make_mesh({"time": 8}, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="expected 2 shard pieces"):
        engine(4, mesh=mesh(2)).feed([np.zeros((2, 40), np.complex64)])


@pytest.mark.parametrize("kw", [dict(eager=True, block_frames=1),
                                dict(hunt_stride=2, block_frames=2)],
                         ids=["eager", "hunt_stride2"])
def test_serving_modes_under_mesh(kw):
    """Eager serving and the stride-2 hunt compose with mesh=: two
    channels on two shards emit the unsharded engine's tuples; eager also
    when fed per-shard pieces (a list, one (1, n) piece per shard)."""
    s, frames = _signal(4)
    x = np.stack([s, np.concatenate([np.zeros(311, np.complex64), s])[:len(s)]])
    ref = _run(engine(2, **kw), x, chunk=50_001)
    assert sum(r[1] == bytes(frames[0]) for r in ref) == 2
    assert _run(engine(2, mesh=mesh(2), **kw), x, chunk=50_001) == ref
    if kw.get("eager"):
        sd = engine(2, mesh=mesh(2), **kw)
        out = []
        for off in range(0, x.shape[1], 50_001):
            out += sd.feed([x[:1, off:off + 50_001], x[1:, off:off + 50_001]])
        assert out + sd.flush() == ref


@pytest.fixture(scope="module")
def wideband8():
    """K = 8: stations on channels 1 and 4 (3 frames each), 2000 channel
    samples of lead, and the unsharded receiver's tuples over ragged
    feeds."""
    k = 8
    sets = {1: build_bert_frame("W5NYV", frame_num=np.arange(3)),
            4: build_bert_frame("TEST", frame_num=np.arange(3) + 12)}
    pad = np.zeros(2000 * k, np.complex128)
    wb = {c: np.concatenate([pad, msk_wideband(f, k)])
          for c, f in sets.items()}
    x = synthesize_wideband(wb, k, max(map(len, wb.values())))
    rx = WidebandReceiver(k, block_frames=1, device="cpu")
    return x, sets, _wideband_run(rx, x)


def _wideband_run(rx, x):
    out = rx.feed(x[:rx.window])
    off = rx.window
    while off + rx.quantum <= len(x):
        out += rx.feed(x[off:off + rx.quantum])
        off += rx.quantum
    return out + rx.feed(x[off:]) + rx.flush()


@pytest.mark.parametrize("nch", [8, 4])
def test_wideband_mesh_equals_unsharded(wideband8, nch):
    """WidebandReceiver(8, mesh=('ch'=nch)): each shard channelizes its
    own DFT columns from the (replicated) window and feeds its engine
    shard; the unsharded receiver's tuples, every transmitted frame
    byte-exact, no clean frame on a quiet channel."""
    x, sets, ref = wideband8
    rx = WidebandReceiver(8, block_frames=1, mesh=mesh(nch))
    assert _wideband_run(rx, x) == ref
    assert len(rx._bufs) == 1         # one window replica: one device
    for c, frames in sets.items():
        got = [r[1] for r in ref if r[0] == c and r[2] <= 16]
        assert got == [bytes(f) for f in frames]
    assert not [r for r in ref if r[0] not in sets and r[2] <= 16]
