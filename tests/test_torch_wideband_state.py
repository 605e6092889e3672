"""The port's WidebandReceiver against the JAX package on the CPU, part 2:
the steady path, and checkpoints resumed in the same package and crossing
between the packages mid-stream (tuples held as in
tests/test_torch_wideband.py)."""

import numpy as np
import pytest

from test_torch_wideband import WidebandJ, capture, port, same_tuples
from opv_tpu.config import CONFIG
from opv_tpu.core import build_bert_frame
from opv_tpu.stream import load_state as load_j
from opv_tpu.stream import save_state as save_j
from opv_tpu_torch.stream import load_state as load_t
from opv_tpu_torch.stream import save_state as save_t


@pytest.mark.parametrize("quantum_out", [CONFIG.samples_per_frame, None])
def test_steady_path_feeds_one_quantum(quantum_out):
    """After the first window, every quantum-sized feed is channelized and
    handed to the engine as one (K, quantum / K) chunk, at the frame-sized
    quantum and at the default one (the block advance), and the tuples
    equal the JAX receiver's."""
    k = 4
    frames = build_bert_frame("W5NYV", frame_num=np.arange(8))
    x = capture(k, {1: frames})
    kw = dict(block_frames=3, quantum_out=quantum_out)

    def steady(rx):
        out = rx.feed(x[: rx.window])
        off = rx.window
        while off + rx._quantum <= len(x):
            out += rx.feed(x[off:off + rx._quantum])
            off += rx._quantum
        return out, (off - rx.window) // rx._quantum

    rx = port(k, **kw)
    feeds, feed = [], rx.demod.feed
    rx.demod.feed = lambda ch: feeds.append(tuple(ch.shape)) or feed(ch)
    out, n_steady = steady(rx)
    assert n_steady >= 1
    assert feeds[-n_steady:] == [(k, rx.quantum // k)] * n_steady
    same_tuples(out, steady(WidebandJ(k, **kw))[0], {1: frames})


def test_checkpoint_resume_identical(tmp_path):
    """TestWidebandReceiver.test_checkpoint_resume_identical on the port."""
    k = 4
    x = capture(k, {2: build_bert_frame("W5NYV", frame_num=np.arange(8))})
    rx0 = port(k, block_frames=3)
    base = rx0.feed(x) + rx0.flush()
    cut = len(x) // 2 - 777
    rx1 = port(k, block_frames=3)
    head = rx1.feed(x[:cut])
    save_t(str(tmp_path / "wb"), rx1.state_tree())
    rx2 = port(k, block_frames=3)
    rx2.load_state_tree(load_t(str(tmp_path / "wb"), rx1.state_tree()))
    tail = rx2.feed(x[cut:]) + rx2.flush()
    assert head + tail == base
    with pytest.raises(ValueError, match="geometry"):
        port(k, block_frames=2).load_state_tree(rx1.state_tree())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A state_tree saved mid-stream by one package's save_state resumes in
    the other package's receiver; the combined stream equals the
    uninterrupted JAX stream (tree layouts equal: the wideband window,
    count and the engine's tree)."""
    k = 4
    sets = {2: build_bert_frame("W5NYV", frame_num=np.arange(8))}
    x = capture(k, sets)
    ref = WidebandJ(k, block_frames=3)
    base = ref.feed(x) + ref.flush()
    cut = len(x) // 2 - 777
    first, second = ((WidebandJ(k, block_frames=3), port(k, block_frames=3))
                     if direction == "jax_to_port" else
                     (port(k, block_frames=3), WidebandJ(k, block_frames=3)))
    save = save_j if direction == "jax_to_port" else save_t
    load = load_t if direction == "jax_to_port" else load_j
    head = first.feed(x[:cut])
    save(str(tmp_path / "ck"), first.state_tree())
    second.load_state_tree(load(str(tmp_path / "ck"), second.state_tree()))
    tail = second.feed(x[cut:]) + second.flush()
    same_tuples(head + tail, base, sets)
