"""The tracking loop's twin (ops/track_symbols.py) against
opv_tpu/rx/demod.py on the CPU, on the inputs where the CUDA kernel's
shared-memory sample ring meets an edge (chip_smoke.track_edge_case): a
whole-capture launch as rx_batch runs it, buffers of 64 and 100 samples
with n_valid under the 50-sample gate, and the last active symbol's window
clamped at cap - 64.  The card tests hold the kernel against this twin on
the same inputs (tests/test_torch_cuda.py), so this holds them to the JAX
package.  Tolerances as tests/test_torch_tracking.py: soft within
SOFT_RTOL of max|soft|, the state within STATE_RTOL of each field's
magnitude, counts, validity and samples_used equal.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import track_edge_case  # noqa: E402
from opv_tpu.rx import demod as demod_j  # noqa: E402
from opv_tpu_torch.config import CONFIG  # noqa: E402
from opv_tpu_torch.ops import track_symbols as ts  # noqa: E402
from opv_tpu_torch.rx.demod import max_symbols  # noqa: E402

SOFT_RTOL = 1e-11
STATE_RTOL = 1e-9

_demod_j = jax.jit(demod_j.demodulate_block)


def _jax_state(row: np.ndarray) -> demod_j.LoopState:
    """A packed (9,) state row as JAX's 0-d LoopState."""
    f = [jnp.float64(v) for v in row[:5]]
    return demod_j.LoopState(*f, prev_c1=jnp.complex128(row[5] + 1j * row[6]),
                             prev_c2=jnp.complex128(row[7] + 1j * row[8]))


@pytest.mark.parametrize("name", ["whole capture", "cap 64", "cap 100",
                                  "clamp 1", "clamp 2"])
def test_ring_edge_inputs_match_jax(name):
    x, nv, state = track_edge_case(name, torch.device("cpu"))
    maxs = max_symbols(x.shape[1])
    soft, valid, st, used = ts.track_symbols_reference(
        x, nv, state, CONFIG.afc_alpha, maxs)
    for c in range(x.shape[0]):
        soft_j, valid_j, st_j, used_j = _demod_j(
            jnp.asarray(x[c].numpy()), jnp.int32(int(nv[c])),
            _jax_state(state[c].numpy()))
        assert np.array_equal(valid[c].numpy(), np.asarray(valid_j))
        assert int(used[c]) == int(used_j)
        soft_j = np.asarray(soft_j)
        err = np.abs(soft[c].numpy() - soft_j).max()
        assert err <= SOFT_RTOL * max(1.0, np.abs(soft_j).max())
        want = np.array([float(st_j.mu), float(st_j.phase_f1),
                         float(st_j.phase_f2), float(st_j.freq_offset),
                         float(st_j.timing_freq), complex(st_j.prev_c1).real,
                         complex(st_j.prev_c1).imag, complex(st_j.prev_c2).real,
                         complex(st_j.prev_c2).imag])
        got = st[c].numpy()
        assert np.all(np.abs(got - want) <= STATE_RTOL * np.maximum(1.0, np.abs(want)))
    if name == "cap 64":
        assert not valid.any() and used.tolist() == [0, 0]
    elif name.startswith("clamp"):
        # symbol 60 is active and its base pos - 11 lies above cap - 64
        assert valid.sum(1).tolist() == [61]
        pos60 = int(ts.track_symbols_reference(x, nv, state, CONFIG.afc_alpha,
                                               60)[3][0])
        assert pos60 - 11 > x.shape[1] - 64
