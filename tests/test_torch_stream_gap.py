"""The gap-burst seeds that chip_smoke.py's stream phase leaves out, on
the very feed that script makes (chip_smoke.gap_burst, on the CPU with
the port's TX), through the JAX package's engine and the port's (CPU
tensors).  Their noise gaps cost frames of burst 2 — a noise slot whose
sync quality reaches 0.70 keeps the flywheel's lock alive past the gap —
and the two engines must lose the same ones.

Tolerance: identical tuple streams — channel, frame bytes, Viterbi metric
and absolute position equal, sync quality within 1e-4.  int8 engines run
with agc=False in both packages."""

import pathlib
import sys

import pytest
import torch

import opv_tpu.stream as sj
import opv_tpu_torch.stream as st
from stream_scenarios import assert_same_stream, run

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import (STREAM_BF, STREAM_BURST_FRAMES,  # noqa: E402
                        STREAM_GAP_SEEDS, gap_burst, padded)


@pytest.mark.parametrize("seed,dtype,kept", [(2, "float32", 10),
                                             (2, "int8", 12),
                                             (9, "float32", 12),
                                             (9, "int8", 6)])
def test_left_out_gap_seeds_match_jax(seed, dtype, kept):
    """Both engines emit `kept` of the 12 transmitted frames, the same
    tuples; every lost frame belongs to burst 2."""
    assert seed not in STREAM_GAP_SEEDS
    b, sent = gap_burst(torch.device("cpu"), seed=seed)
    x = padded(b, -(-len(b) // 40) * 40 + 40_000).numpy()[None]
    kw = dict(block_frames=STREAM_BF, dtype=dtype, agc=False)
    want = run(sj.LockedStreamDemodulator(1, **kw), x)
    got = run(st.LockedStreamDemodulator(1, device="cpu", **kw), x)
    assert_same_stream(got, want)
    frames = [bytes(f.numpy()) for f, _ in sent]
    emitted = {r[1] for r in got if r[1] in frames}
    assert len(emitted) == kept
    assert set(frames[:STREAM_BURST_FRAMES]) <= emitted
