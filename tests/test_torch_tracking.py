"""The port's AFC/TED symbol-tracking loop (opv_tpu_torch/rx/demod.py over
ops/track_symbols.py's twin) against opv_tpu/rx/demod.py on the CPU.

The JAX reference runs its lax.scan on complex128 (tests/conftest.py turns
x64 on); without its optional C tracking extension built, JAX's streaming
"auto" backend is that same scan.  Tolerance: soft within SOFT_RTOL of
max|soft| and the loop state within STATE_RTOL of each field's magnitude
(the twin takes its LO from torch's sin/cos and sums the 40 taps in
another order than XLA; ~2e-15 seen); symbol counts, validity and
samples_used must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.rx import demod as demod_j
from opv_tpu.rx.cfo import estimate_cfo as estimate_cfo_j
from opv_tpu_torch.ops import track_symbols as ts
from opv_tpu_torch.rx import demod as demod_t
from opv_tpu_torch.rx.cfo import estimate_cfo as estimate_cfo_t

SOFT_RTOL = 1e-11
STATE_RTOL = 1e-9
CHUNK = 86_720


def _load(golden_dir, name):
    raw = np.fromfile(golden_dir / f"{name}.iq", dtype="<i2").reshape(-1, 2)
    return raw[:, 0].astype(np.float64) + 1j * raw[:, 1].astype(np.float64)


_demod_j = jax.jit(demod_j.demodulate_block)


def _jax_call(x, n_valid, state):
    soft, valid, st, used = _demod_j(jnp.asarray(x), jnp.int32(n_valid), state)
    return np.asarray(soft), np.asarray(valid), st, int(used)


def _close_state(st_t, st_j, i=0):
    for name, a, b in zip(demod_t.LoopState._fields, st_t, st_j):
        a, b = a[i].numpy(), np.asarray(b)
        assert abs(a - b) <= STATE_RTOL * max(1.0, abs(b)), (name, a, b)


@pytest.mark.parametrize("name", ["bert3", "cfo500"])
def test_two_calls_match_jax(golden_dir, name):
    """Two chunks of a golden capture, the second from the first's state
    and leftover (as the streaming receiver chains them); the first chunk
    partial (n_valid < CAP) to exercise the active gate."""
    s = _load(golden_dir, name)
    off = float(estimate_cfo_j(jnp.asarray(s[:CHUNK])))
    st_j = demod_j.loop_state_init(off)
    st_t = demod_t.loop_state_init(off, channels=1)
    start, n_valid = 0, CHUNK - 7_001
    for _ in range(2):
        x = s[start:start + CHUNK]
        soft_j, valid_j, st_j, used_j = _jax_call(x, n_valid, st_j)
        soft_t, valid_t, st_t, used_t = demod_t.demodulate_block(
            torch.from_numpy(x)[None], torch.tensor([n_valid]), st_t)
        assert np.array_equal(valid_t[0].numpy(), valid_j)
        assert int(used_t[0]) == used_j
        err = np.abs(soft_t[0].numpy() - soft_j).max()
        assert err <= SOFT_RTOL * np.abs(soft_j).max()
        _close_state(st_t, st_j)
        start, n_valid = start + used_j, CHUNK


def test_channels_are_independent(golden_dir):
    """Three channels in one call equal three one-channel calls (the twin
    batches the taps over channels, so nothing may leak between them);
    each channel its own n_valid and state."""
    names = ("bert3", "cfo500", "drift")
    x = torch.from_numpy(np.stack([_load(golden_dir, n)[:CHUNK] for n in names]))
    offs = [float(estimate_cfo_t(x[c])) for c in range(3)]
    nv = torch.tensor([CHUNK, 40_001, 60_000])
    st = demod_t.loop_state_init(torch.tensor(offs), channels=3)
    soft, valid, st2, used = demod_t.demodulate_block(x, nv, st, afc_alpha=0.01)
    for c in range(3):
        one = demod_t.loop_state_init(offs[c], channels=1)
        s1, v1, st1, u1 = demod_t.demodulate_block(x[c:c + 1], nv[c:c + 1], one,
                                                   afc_alpha=0.01)
        assert torch.equal(soft[c], s1[0]) and torch.equal(valid[c], v1[0])
        assert int(used[c]) == int(u1[0])
        for a, b in zip(st2, st1):
            assert torch.equal(a[c], b[0])


@pytest.mark.parametrize("name", ["bert3", "cfo500", "awgn10", "raw3",
                                  "drift"])
def test_estimate_cfo_matches_jax(golden_dir, name):
    """The single-channel coarse/fine grid search gives JAX's offset, on a
    whole chunk and on a buffer shorter than the 1000-symbol window."""
    s = _load(golden_dir, name)
    for x in (s[:CHUNK], s[:30_017]):
        assert float(estimate_cfo_t(torch.from_numpy(x))) == \
            float(estimate_cfo_j(jnp.asarray(x)))


def test_layout_matches_jax():
    """LoopState fields in JAX's order, max_symbols equal, and the
    kernel's packed rows round-trip."""
    assert demod_t.LoopState._fields == demod_j.LoopState._fields
    for cap in (64, 1000, CHUNK, CHUNK + 4096, 264_160):
        assert demod_t.max_symbols(cap) == demod_j.max_symbols(cap)
    st = demod_t.LoopState(*(torch.arange(3, dtype=torch.float64) + i
                             for i in range(5)),
                           torch.complex(torch.ones(3, dtype=torch.float64),
                                         -torch.ones(3, dtype=torch.float64)),
                           torch.zeros(3, dtype=torch.complex128))
    rows = demod_t.pack_state(st)
    assert rows.shape == (3, ts.STATE_WIDTH)
    for a, b in zip(demod_t.unpack_state(rows), st):
        assert torch.equal(a, b)


def test_float32_and_cuda_wrapper_refuse():
    """complex64 samples run the float32 loop (its state rounded to
    float32); the wrapper refuses a state of the other precision; the CUDA
    wrapper takes no CPU tensor and launches nothing."""
    st = demod_t.loop_state_init(0.0, channels=1)
    soft, _, st2, _ = demod_t.demodulate_block(
        torch.zeros((1, 128), dtype=torch.complex64), torch.tensor([128]), st)
    assert soft.dtype == torch.float32 and st2.mu.dtype == torch.float32
    x64 = torch.zeros((1, 128), dtype=torch.complex64)
    with pytest.raises(ValueError, match="float32"):
        ts.track_symbols_reference(x64, torch.tensor([128], dtype=torch.int32),
                                   demod_t.pack_state(st), 0.001, 5)
    n0 = dict(ts.track_symbols_cuda.launches)
    with pytest.raises(ValueError):
        ts.track_symbols_cuda(torch.zeros((1, 128), dtype=torch.complex128),
                              torch.tensor([128], dtype=torch.int32),
                              demod_t.pack_state(st), 0.001, 5)
    assert ts.track_symbols_cuda.launches == n0
