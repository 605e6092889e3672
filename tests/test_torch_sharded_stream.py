"""The port's sharded stream (opv_tpu_torch/stream/sharded.py) against
tests/test_sharded_stream.py's four cases and against the JAX package's
ShardedStreamDemodulator on the CPU, on a (ch=2, time=2) mesh: the port's
names the CPU four times, the JAX package's takes four of its eight
virtual CPU devices (tests/conftest.py).

Tolerances.  The JAX comparisons run with the CFO grid off
(estimate_cfo_flag=False): channel, bytes, metric and position of every
tuple identical, sync quality within Q_TOL (float32 sums in another
order).  The port's own runs are held to the transmitted frames: each
exactly once, byte-exact, at its sync position +-1 sample (the apex
plateau under the shard's own CFO estimate, as in the JAX test; exact
with the grid off)."""

import numpy as np
import pytest
import jax.numpy as jnp

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.parallel import make_mesh as make_mesh_j
from opv_tpu.stream import ShardedStreamDemodulator as ShardedJ
from opv_tpu.stream.state import save_state as save_state_j
from opv_tpu.tx import modulate_frames, tx_flush_zeros
from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.parallel import make_mesh
from opv_tpu_torch.parallel.sharded import HALO_SAMPLES
from opv_tpu_torch.stream import ShardedStreamDemodulator, load_state, \
    save_state

SPF = CONFIG.samples_per_frame
NCH, NTIME = 2, 2
SHARD = HALO_SAMPLES       # the smallest legal window slice (87,680)
Q_TOL = 1e-5
EXACT = dict(estimate_cfo_flag=False)


@pytest.fixture(scope="module")
def capture4():
    """4 BERT frames on 2 channels (the same signal), ~351k samples: the
    window is 175,360, so >= 3 windows stream."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(4))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    return np.stack([s] * NCH), np.asarray(frames)


def make_sd(**kw):
    mesh = make_mesh({"ch": NCH, "time": NTIME}, devices=["cpu"] * 4)
    return ShardedStreamDemodulator(mesh, channels=NCH, shard_samples=SHARD,
                                    max_frames_per_shard=4, **kw)


def make_jax(**kw):
    return ShardedJ(make_mesh_j({"ch": NCH, "time": NTIME}), channels=NCH,
                    shard_samples=SHARD, max_frames_per_shard=4, **kw)


def run_stream(sd, samples, chunk):
    out = []
    for off in range(0, samples.shape[1], chunk):
        out.extend(sd.feed(samples[:, off:off + chunk]))
    return out + sd.flush()


def same_tuples(got, want):
    assert [(t[0], t[1], t[2], t[4]) for t in got] == \
        [(t[0], t[1], t[2], t[4]) for t in want]
    assert max((abs(a[3] - b[3]) for a, b in zip(got, want)),
               default=0.0) <= Q_TOL


@pytest.fixture(scope="module")
def jax_stream(capture4, tmp_path_factory):
    """The JAX demodulator over the capture, CFO off: its first half, a
    checkpoint written there (the path returned), then the rest in
    13,337-sample feeds."""
    samples, _ = capture4
    cut = samples.shape[1] // 2
    sj = make_jax(**EXACT)
    out = sj.feed(samples[:, :cut])
    ck = str(tmp_path_factory.mktemp("jax") / "ck")
    save_state_j(ck, sj.state_tree())
    return out + run_stream(sj, samples[:, cut:], 13_337), ck, len(out)


@pytest.fixture(scope="module")
def whole(capture4):
    """The port's demodulator fed the whole capture at once, CFO off."""
    samples, _ = capture4
    sd = make_sd(**EXACT)
    return sd, run_stream(sd, samples, samples.shape[1])


def test_every_frame_exactly_once(capture4, whole):
    _, frames = capture4
    sd, out = whole
    assert len(out) == sd.decoded == NCH * len(frames)
    for c in range(NCH):
        mine = [r for r in out if r[0] == c]
        got = np.stack([np.frombuffer(r[1], np.uint8) for r in mine])
        np.testing.assert_array_equal(got, frames)
        pos = np.array([r[4] for r in mine])
        np.testing.assert_array_equal(pos, np.arange(len(frames)) * SPF)
    # the window is born sharded: one (C/nch, shard) block per grid entry
    assert {k: tuple(b.shape) for k, b in sd._buf.items()} == \
        {(i, j): (1, SHARD) for i in range(NCH) for j in range(NTIME)}


def test_batch_seam_straddle(capture4):
    """Frame 2 spans [173,440, 260,160), across the first window's end at
    175,360 on every shard: it decodes once, in the second window."""
    samples, frames = capture4
    sd = make_sd()
    first = sd.feed(samples[:, :sd.window])
    rest = sd.feed(samples[:, sd.window:]) + sd.flush()
    first_pos = np.array(sorted(r[4] for r in first))
    assert not np.any(np.abs(first_pos - 2 * SPF) <= 1)
    assert np.any(np.abs(first_pos - 1 * SPF) <= 1)
    seam = [r for r in rest if abs(r[4] - 2 * SPF) <= 1]
    assert len(seam) == NCH
    for r in seam:
        np.testing.assert_array_equal(np.frombuffer(r[1], np.uint8),
                                      frames[2])
    assert len(first) + len(rest) == NCH * len(frames)


def test_slicing_invariance_and_jax_tuples(capture4, whole, jax_stream):
    """Feeds of 13,337 samples give the whole capture's tuples, which are
    the JAX demodulator's, tuple for tuple."""
    samples, frames = capture4
    got = run_stream(make_sd(**EXACT), samples, 13_337)
    assert got == whole[1]
    same_tuples(got, jax_stream[0])
    assert len(got) == NCH * len(frames)


def test_checkpoint_resume_mid_stream(capture4, jax_stream, tmp_path):
    """state_tree -> save -> load resumes to the same emissions: the port
    from its own checkpoint, and the port from the JAX demodulator's checkpoint
    (the packages share the .npz layout), equal to the JAX demodulator's
    uninterrupted stream."""
    samples, frames = capture4
    cut = samples.shape[1] // 2
    sd = make_sd()
    head = sd.feed(samples[:, :cut])
    save_state(str(tmp_path / "ck"), sd.state_tree())
    sd2 = make_sd()
    sd2.load_state_tree(load_state(str(tmp_path / "ck"), sd2.state_tree()))
    tail_a = sd.feed(samples[:, cut:]) + sd.flush()
    tail_b = sd2.feed(samples[:, cut:]) + sd2.flush()
    assert tail_a == tail_b
    assert len(head) + len(tail_a) == NCH * len(frames)

    want, ck, n_head = jax_stream
    sp = make_sd(**EXACT)
    sp.load_state_tree(load_state(ck, sp.state_tree()))
    tail_p = sp.feed(samples[:, cut:]) + sp.flush()
    same_tuples(want[:n_head] + tail_p, want)
