"""The port's sync stage (opv_tpu_torch/rx/sync.py: sync_correlate, the
state machine over ops/sync_scan.py's twin, sync_correlate_scan,
extract_payload_windows) against opv_tpu/rx/sync.py on the CPU.  Every
output is compared exactly: the correlation is the same 24 shifted adds in
the same order, and the state machine and the gather only compare, select
and copy."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.rx import sync as sync_j
from opv_tpu_torch.ops import sync_scan as sc
from opv_tpu_torch.rx import sync as sync_t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import plant_sync, sync_stress  # noqa: E402

EB = 2144
FS = 2168


@pytest.fixture(scope="module")
def bert3_soft(golden_dir):
    """bert3's soft symbols from the port's demodulator (one call)."""
    from opv_tpu_torch.rx.cfo import estimate_cfo
    from opv_tpu_torch.rx.demod import demodulate_block, loop_state_init
    raw = np.fromfile(golden_dir / "bert3.iq", dtype="<i2").reshape(-1, 2)
    x = torch.from_numpy(raw[:, 0].astype(np.float64) + 1j * raw[:, 1])
    st = loop_state_init(estimate_cfo(x).reshape(1), channels=1)
    soft, valid, _, _ = demodulate_block(x[None], torch.tensor([len(x)]), st)
    return soft[0], valid[0]


def _state_j(row, q=0.0):
    state, sss, misses, coll, total, frames = (int(v) for v in row)
    return sync_j.SyncTrackerState(
        state=jnp.int32(state), sss=jnp.int32(sss), misses=jnp.int32(misses),
        sync_q=jnp.float64(q), collecting=jnp.bool_(coll),
        total=jnp.int32(total), frames=jnp.int32(frames))


def _scan_both(raw, norm, valid, ints):
    """The port's machine over all rows at once, JAX's row by row; every
    output equal."""
    c = raw.shape[0]
    st_t = sync_t.SyncTrackerState(
        state=ints[:, 0], sss=ints[:, 1], misses=ints[:, 2],
        sync_q=torch.zeros(c, dtype=torch.float64), collecting=ints[:, 3] != 0,
        total=ints[:, 4], frames=ints[:, 5])
    got = sync_t.sync_scan(st_t, raw, norm, valid)
    for i in range(c):
        want = sync_j.sync_scan(_state_j(ints[i].tolist()),
                                jnp.asarray(raw[i].numpy()),
                                jnp.asarray(norm[i].numpy()),
                                jnp.asarray(valid[i].numpy()))
        for f, a, b in zip(sync_j.SyncTrackerState._fields, got[0], want[0]):
            assert a[i].item() == np.asarray(b).item(), f
        for k, (a, b) in enumerate(zip(got[1:], want[1:])):
            assert np.array_equal(a[i].numpy(), np.asarray(b)), k
    return got


def test_correlate_and_scan_match_jax(bert3_soft):
    """bert3's soft stream from a zero history: raw and norm bit-equal,
    then the machine's three frames, events and state."""
    soft, valid = bert3_soft
    ext = torch.cat([torch.zeros(23, dtype=torch.float64), soft])
    raw_t, norm_t = sync_t.sync_correlate(ext[None])
    raw_j, norm_j = sync_j.sync_correlate(jnp.asarray(ext.numpy()))
    assert np.array_equal(raw_t[0].numpy(), np.asarray(raw_j))
    assert np.array_equal(norm_t[0].numpy(), np.asarray(norm_j))
    got = _scan_both(raw_t, norm_t, valid[None],
                     torch.zeros((1, 6), dtype=torch.int32))
    assert int(got[1].sum()) == 3
    assert got[3][0][got[3][0] > 0].tolist() == [sync_t.EV_HUNT_VERIFY,
                                                sync_t.EV_VERIFY_LOCK,
                                                sync_t.EV_SYNC_OK,
                                                sync_t.EV_SYNC_OK,
                                                sync_t.EV_SYNC_MISS]


def test_stress_matches_jax():
    """Inputs that reach every transition (chip_smoke.sync_stress: all
    three start states, thresholds on both sides, the 2^30 total cap,
    invalid steps): every output of every row equal to JAX's."""
    raw, norm, valid, ints, _ = sync_stress(6, 3000, torch.device("cpu"))
    got = _scan_both(raw, norm, valid, ints)
    assert set(got[3].unique().tolist()) == set(range(6))


@pytest.mark.parametrize("max_frames", [2, 3, 8])
def test_extract_payload_windows_matches_jax(max_frames):
    """Slots fill in symbol order and stop at max_frames; empty slots hold
    -1; payload starts clamp at both ends; q at each slot's symbol."""
    rng = np.random.default_rng(max_frames)
    s = 7000
    cat = rng.standard_normal(EB + s)
    q = rng.standard_normal(s)
    ready = np.zeros(s, bool)
    ready[[0, 100, 2300, 4500, 6999]] = True
    got = sync_t.extract_payload_windows(
        torch.from_numpy(cat)[None], torch.from_numpy(ready)[None],
        torch.from_numpy(q)[None], max_frames)
    want = sync_j.extract_payload_windows(jnp.asarray(cat), jnp.asarray(ready),
                                          jnp.asarray(q), max_frames)
    for a, b in zip(got, want):
        assert np.array_equal(a[0].numpy(), np.asarray(b))


def test_layout_and_codes_match_jax():
    assert sync_t.SyncTrackerState._fields == sync_j.SyncTrackerState._fields
    assert (sync_t.EV_NONE, sync_t.EV_HUNT_VERIFY, sync_t.EV_VERIFY_LOCK,
            sync_t.EV_SYNC_OK, sync_t.EV_SYNC_MISS, sync_t.EV_LOSE_LOCK) == \
        (sync_j.EV_NONE, sync_j.EV_HUNT_VERIFY, sync_j.EV_VERIFY_LOCK,
         sync_j.EV_SYNC_OK, sync_j.EV_SYNC_MISS, sync_j.EV_LOSE_LOCK)
    init = sync_t.sync_tracker_init()
    for a, b in zip(init, sync_j.sync_tracker_init()):
        assert a.shape == () and a.item() == np.asarray(b).item()


def _correlate_scan_both(ext, valid, ints):
    """The port's sync_correlate_scan over all rows at once, JAX's
    sync_correlate then sync_scan row by row; every output equal (floats
    as bits).  Returns the port's outputs."""
    c = ext.shape[0]
    st_t = sync_t.SyncTrackerState(
        state=ints[:, 0], sss=ints[:, 1], misses=ints[:, 2],
        sync_q=torch.zeros(c, dtype=torch.float64), collecting=ints[:, 3] != 0,
        total=ints[:, 4], frames=ints[:, 5])
    got = sync_t.sync_correlate_scan(st_t, ext, valid)
    for i in range(c):
        raw, norm = sync_j.sync_correlate(jnp.asarray(ext[i].numpy()))
        want = sync_j.sync_scan(_state_j(ints[i].tolist()), raw, norm,
                                jnp.asarray(valid[i].numpy()))
        for f, a, b in zip(sync_j.SyncTrackerState._fields, got[0], want[0]):
            assert a[i].item() == np.asarray(b).item(), f
        for k, (a, b) in enumerate(zip(got[1:], (raw, norm, *want[1:]))):
            assert a[i].numpy().tobytes() == np.asarray(b).tobytes(), k
    return got


def _ints0(c):
    return torch.zeros((c, 6), dtype=torch.int32)


def test_correlate_scan_matches_jax(bert3_soft):
    """bert3's soft stream from a zero history through sync_correlate_scan:
    raw, norm, the machine's outputs and state equal JAX's sync_correlate
    then sync_scan."""
    soft, valid = bert3_soft
    ext = torch.cat([torch.zeros(23, dtype=torch.float64), soft])[None]
    got = _correlate_scan_both(ext, valid[None], _ints0(1))
    assert int(got[3].sum()) == 3


def test_correlate_scan_split_matches_jax(bert3_soft):
    """bert3's stream in two calls, the state and the last 23 soft symbols
    carried: the outputs are those of one JAX run over the whole stream."""
    soft, valid = bert3_soft
    cut = 3000
    assert bool(valid[:cut].all())
    ext = torch.cat([torch.zeros(23, dtype=torch.float64), soft])
    st = sync_t.sync_tracker_init(1)
    first = sync_t.sync_correlate_scan(st, ext[None, :23 + cut],
                                       valid[None, :cut])
    second = sync_t.sync_correlate_scan(first[0], ext[None, cut:],
                                        valid[None, cut:])
    raw, norm = sync_j.sync_correlate(jnp.asarray(ext.numpy()))
    want = sync_j.sync_scan(sync_j.sync_tracker_init(), raw, norm,
                            jnp.asarray(valid.numpy()))
    for f, a, b in zip(sync_j.SyncTrackerState._fields, second[0], want[0]):
        assert a[0].item() == np.asarray(b).item(), f
    for k, (a, b, w) in enumerate(zip(first[1:], second[1:],
                                      (raw, norm, *want[1:]))):
        assert torch.cat([a[0], b[0]]).numpy().tobytes() == \
            np.asarray(w).tobytes(), k


def planted_stream(seed: int = 3):
    """A soft stream (numpy noise from `seed`, sigma 20) whose planted
    sync words reach every transition from HUNTING: a hunt hit at symbol
    100, VERIFYING -> LOCKED, sync OK, a flywheel miss (a word at norm
    0.67), OK, then words at norm 0.67 for five checks (four misses, lost
    lock at the fifth) and a new hunt hit 24 symbols after it, LOCKED
    again, sync OK.  Returns
    (soft_ext (23 + S,), the lost lock's symbol)."""
    rng = np.random.default_rng(seed)
    lost = 100 + 8 * FS
    s = lost + 24 + FS + 200
    x = rng.normal(0.0, 20.0, 23 + s)
    plant_sync(x, 100, 1000.0)
    plant_sync(x, 100 + FS, 1000.0)
    plant_sync(x, 100 + 2 * FS, 1000.0, flips=4)
    plant_sync(x, 100 + 3 * FS, 1000.0)
    for k in range(4, 9):
        plant_sync(x, 100 + k * FS, 1000.0, flips=4)
    plant_sync(x, lost + 24, 1000.0)
    plant_sync(x, lost + 24 + FS, 1000.0)
    return torch.from_numpy(x), lost


def test_correlate_scan_planted_matches_jax():
    """The planted stream (every event code, a lost lock and a hunt hit 24
    symbols apart), and again with a few invalid symbols and from a
    LOCKED, collecting carry: every output equal to JAX's."""
    x, lost = planted_stream()
    s = x.shape[0] - 23
    valid = torch.ones((3, s), dtype=torch.bool)
    valid[1, [7, 2500, 9000, 9001]] = False
    ints = _ints0(3)
    ints[2] = torch.tensor([2, 17, 2, 1, 100, 4])
    got = _correlate_scan_both(x.expand(3, -1), valid, ints)
    ev = got[5][0]
    assert ev[lost].item() == sync_t.EV_LOSE_LOCK
    assert ev[lost + 24].item() == sync_t.EV_HUNT_VERIFY
    assert ev[ev > 0].tolist() == [
        sync_t.EV_HUNT_VERIFY, sync_t.EV_VERIFY_LOCK, sync_t.EV_SYNC_OK,
        sync_t.EV_SYNC_MISS, sync_t.EV_SYNC_OK, *[sync_t.EV_SYNC_MISS] * 4,
        sync_t.EV_LOSE_LOCK, sync_t.EV_HUNT_VERIFY, sync_t.EV_VERIFY_LOCK,
        sync_t.EV_SYNC_OK]
    assert int(got[3][0].sum()) == 9


def test_correlate_scan_strided_view_matches_jax():
    """sync_correlate_scan on the view soft_cat[:, eb - 23:] that
    rx_block_from_soft hands it (rows 8 bytes off 16 at a stride of
    eb + S): the outputs of the same rows copied out."""
    x, _ = planted_stream(seed=4)
    s = x.shape[0] - 23
    cat = torch.zeros((2, EB + s), dtype=torch.float64)
    cat[:, EB - 23:] = x
    cat[1, EB - 23:EB + 40] = 0.0
    view = cat[:, EB - 23:]
    assert view.stride() == (EB + s, 1) and view.data_ptr() % 16 == 8
    _correlate_scan_both(view, torch.ones((2, s), dtype=torch.bool),
                         _ints0(2))


def test_cuda_wrapper_refuses_cpu_tensors():
    z = torch.zeros((1, 4), dtype=torch.float64)
    ints, q = torch.zeros((1, 6), dtype=torch.int32), torch.zeros(1, dtype=torch.float64)
    n0 = dict(sc.sync_scan_cuda.launches)
    with pytest.raises(ValueError):
        sc.sync_scan_cuda(z, z, z.bool(), ints, q)
    with pytest.raises(ValueError):
        sc.sync_correlate_scan_cuda(torch.zeros((1, 27), dtype=torch.float64),
                                    z.bool(), ints, q)
    assert sc.sync_scan_cuda.launches == n0
