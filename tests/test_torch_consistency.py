"""Cross-architecture consistency of the port (tests/test_consistency.py on
opv_tpu_torch): seeded random impairments (delay, CFO, Eb/N0 10-14 dB)
through the port's three receivers on the CPU, the locked engine
(LockedStreamDemodulator, random feed chunks), the feed-forward dense
receiver (rx_fast) and the reference-parity tracking loop
(StreamingDemodulator).  Each must recover the frames the JAX package's
same receiver recovers, and the locked and dense receivers every
transmitted frame; the tracking loop may lose leading frames to AFC
convergence (reference behaviour), never decode a wrong one."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.rx.fast import rx_fast as rx_fast_j
from opv_tpu.stream import LockedStreamDemodulator as LockedJ
from opv_tpu.stream import StreamingDemodulator as TrackingJ
from opv_tpu_torch.rx.fast import rx_fast
from opv_tpu_torch.stream import LockedStreamDemodulator, StreamingDemodulator
from test_consistency import F, _feed_chunked, _scenario


def _locked(engine, x, seed):
    rng = np.random.default_rng(seed + 1)
    return [r[1] for r in _feed_chunked(engine, x, rng)]


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_three_paths_recover_the_same_frames(seed):
    s, expected, draw = _scenario(seed)
    x = s.astype(np.complex64)[None, :]

    got = _locked(LockedStreamDemodulator(1, block_frames=3, device="cpu"),
                  x, seed)
    assert got == expected, f"locked path, draw {draw}"
    assert _locked(LockedJ(1, block_frames=3), x, seed) == got

    out = rx_fast(torch.from_numpy(x))
    fast = [bytes(f) for f in out["frames"][0][out["frame_valid"][0]].numpy()]
    assert fast == expected, f"fast path, draw {draw}"
    out = rx_fast_j(jnp.asarray(x))
    fv = np.asarray(out["frame_valid"])[0]
    assert [bytes(f) for f in np.asarray(out["frames"])[0][fv]] == fast

    sd = StreamingDemodulator(device="cpu")
    tracked = [bytes(r[0]) for r in sd.feed(s) + sd.flush()]
    assert len(tracked) >= F - 2, f"tracking path lost >2 frames, {draw}"
    assert tracked == expected[F - len(tracked):], f"tracking path, {draw}"
    sj = TrackingJ()
    assert [bytes(r[0]) for r in sj.feed(s) + sj.flush()] == tracked
