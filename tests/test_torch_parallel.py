"""The port's meshes and sharded feed-forward receivers
(opv_tpu_torch/parallel/) against opv_tpu/parallel/ on the CPU: the JAX
package on its eight virtual CPU devices (tests/conftest.py), the port on a
mesh that names the CPU several times.

Tolerances.  With the CFO grid off (estimate_cfo_flag=False) both packages
correlate the same samples at the same offset: frames, owned/valid,
starts, metrics and n identical, sync_q within Q_TOL (float32 sums taken
in another order), except the inherent divergence of
tests/test_torch_fast.py: the MSK sync apex is a two-sample plateau, so a
start may sit one sample away where the port's raw correlation of the two
samples ties within PLATEAU_RTOL (the frame's bytes and ownership equal).
With each package's own CFO estimate (a curve flat to ~1e-6, tens of Hz
apart on clean captures, ROADMAP queue 3): frames and the count
identical.  The port's sharded receivers against its own
unsharded rx_fast: identical, bit for bit (a shard computes what the whole
bank computes)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.parallel import mesh as mesh_j
from opv_tpu.parallel import sharded as sharded_j
from opv_tpu.parallel.grid import rx_grid_sharded as grid_j
from opv_tpu.tx import modulate_frames, tx_flush_zeros
from opv_tpu_torch import parallel as par
from opv_tpu_torch.parallel import sharded as sharded_t
from opv_tpu_torch.rx.fast import dense_soft, dense_sync, rx_fast

Q_TOL = 1e-5
PLATEAU_RTOL = 1e-6
GRID_KEYS = ("frames", "owned", "starts", "metrics", "sync_q", "n")


@pytest.fixture(scope="module")
def capture8():
    """tests/test_sharding.py's capture: 8 BERT frames through the JAX
    package's fast TX, complex64 with the trailing flush."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(8))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    return (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64), np.asarray(frames)


def cpu_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return par.make_mesh(axes, devices=["cpu"] * n)


def _same_grid(got, want, x):
    """A sharded result of the port (got) and the JAX package (want) on
    samples x, CFO off; returns the number of plateau-tie slots."""
    ties = got["starts"].numpy() != np.asarray(want["starts"])
    for k in GRID_KEYS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        if k == "sync_q":
            np.testing.assert_allclose(a, b, rtol=0, atol=Q_TOL)
        elif k == "metrics":
            np.testing.assert_array_equal(a[~ties], b[~ties], err_msg=k)
        elif k != "starts":
            np.testing.assert_array_equal(a, b, err_msg=k)
    if ties.any():
        raw = dense_sync(dense_soft(torch.from_numpy(x),
                                    torch.zeros(x.shape[0])))[0].numpy()
        for c, k in zip(*np.nonzero(ties)):
            a, b = (int(v["starts"][c, k]) for v in (got, want))
            assert abs(a - b) == 1 and bool(want["owned"][c, k]), (c, k, a, b)
            assert abs(raw[c, a] - raw[c, b]) <= PLATEAU_RTOL * abs(raw[c, a])
    return int(ties.sum())


# ----------------------------------------------------------------- meshes


def test_mesh_constructors_and_repeated_devices():
    m = par.make_mesh({"ch": 2, "time": 4}, devices=["cpu"] * 8)
    assert m.shape == {"ch": 2, "time": 4} and m.axis_names == ("ch", "time")
    assert m.devices.shape == (2, 4) and m.size == 8
    assert {str(d) for d in m.devices.flat} == {"cpu"}
    assert not m.multiprocess and (m.ranks == 0).all()
    assert list(m.shape) == list(mesh_j.make_mesh({"ch": 2, "time": 4}).shape)
    # the first prod(axes) devices, in order
    m = par.make_mesh({"time": 2}, devices=["cpu", "meta", "cpu"])
    assert [d.type for d in m.devices.flat] == ["cpu", "meta"]
    assert par.channel_mesh(4, devices=["cpu"] * 6).shape == {"ch": 4}
    assert par.channel_mesh(devices=["cpu"] * 3).shape == {"ch": 3}
    # a single process's global mesh: (ch, time), time the local devices
    g = par.global_mesh(ch=2, devices=["cpu"] * 4)
    assert g.shape == {"ch": 2, "time": 2} and (g.ranks == 0).all()
    assert par.global_mesh(devices=["cpu"] * 4).shape == {"ch": 1, "time": 4}


def test_mesh_errors():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        par.make_mesh({"ch": 2, "time": 4}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        mesh_j.make_mesh({"ch": 2, "time": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="mesh 3x2 != 4 devices"):
        par.global_mesh(ch=3, time=2, devices=["cpu"] * 4)
    from opv_tpu_torch.parallel.mesh import channel_shards
    with pytest.raises(ValueError, match="'ch' axis"):
        channel_shards(cpu_mesh({"time": 2}), 4)
    with pytest.raises(ValueError, match="divisible"):
        channel_shards(cpu_mesh({"ch": 4}), 6)


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh({"ch": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.global_mesh()
    from opv_tpu_torch.entry import mesh_devices
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_devices(8)
    assert [d.type for d in mesh_devices(3, ["cpu"])] == ["cpu"] * 3


def test_initialize_multihost_without_coordinator_is_a_no_op():
    import torch.distributed as dist
    par.initialize_multihost()
    assert not dist.is_initialized()


def test_check_time_shard_geometry():
    assert sharded_t.HALO_SAMPLES == sharded_j.HALO_SAMPLES == 87_680
    for total, ntime in ((4 * 87_680, 4), (87_679, 1), (100, 1)):
        sharded_t.check_time_shard_geometry(total, ntime)
    for total, ntime in ((4 * 87_679, 4), (200_000, 3)):
        with pytest.raises(ValueError) as et:
            sharded_t.check_time_shard_geometry(total, ntime)
        with pytest.raises(ValueError) as ej:
            sharded_j.check_time_shard_geometry(total, ntime)
        assert str(et.value) == str(ej.value)


# ------------------------------------------------------- sharded receivers


def test_rx_fast_sharded_matches_jax_and_unsharded(capture8):
    """TestChannelParallel: 4 channels over 'ch'=4: the global count and
    the frames equal the JAX package's (each estimating its CFO) and the
    port's own unsharded rx_fast, bit for bit."""
    s, frames = capture8
    x = np.stack([s] * 4)
    fj, nj = sharded_j.rx_fast_sharded(mesh_j.channel_mesh(4), jnp.asarray(x),
                                       max_frames_per_shard=10)
    ft, nt = par.rx_fast_sharded(par.channel_mesh(4, devices=["cpu"] * 4), x,
                                 max_frames_per_shard=10)
    assert int(nt) == int(nj) == 4 * 8
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    local = rx_fast(torch.from_numpy(x), max_frames=10)
    np.testing.assert_array_equal(ft.numpy(), local["frames"].numpy())
    assert int(nt) == int(local["n_decoded"])
    for c in range(4):
        valid = local["frame_valid"][c].numpy()
        np.testing.assert_array_equal(ft[c].numpy()[valid], frames)


@pytest.fixture(scope="module")
def long_capture(capture8):
    """One channel of capture8 zero-padded to 4 time shards."""
    s, frames = capture8
    ntime = 4
    block = (len(s) + ntime - 1) // ntime
    pad = np.zeros(ntime * block - len(s), np.complex64)
    return np.concatenate([s, pad])[None], frames


def test_rx_time_sharded_matches_jax(long_capture):
    """TestTimeSharded: one long channel over 4 time shards, halo exchange
    and seam ownership: every frame exactly once, at its global sync
    position, identical to the JAX package's outputs; the port's own CFO
    estimate gives the same frames."""
    x, frames = long_capture
    want = sharded_j.rx_time_sharded(mesh_j.make_mesh({"time": 4}),
                                     jnp.asarray(x), max_frames_per_shard=6,
                                     estimate_cfo_flag=False)
    mesh = cpu_mesh({"time": 4})
    got = par.rx_time_sharded(mesh, x, max_frames_per_shard=6,
                              estimate_cfo_flag=False)
    assert _same_grid(got, want, x) == 0
    assert int(got["n"]) == len(frames)
    owned = got["owned"][0].numpy()
    np.testing.assert_array_equal(got["frames"][0].numpy()[owned], frames)
    np.testing.assert_array_equal(got["starts"][0].numpy()[owned],
                                  np.arange(len(frames)) * 86_720)
    own = par.rx_time_sharded(mesh, x, max_frames_per_shard=6)
    assert int(own["n"]) == len(frames)
    np.testing.assert_array_equal(
        own["frames"][0].numpy()[own["owned"][0].numpy()], frames)


def test_rx_grid_sharded_matches_jax(long_capture):
    """(ch=2, time=2): two channels (the second 777 samples late) over a
    2 x 2 grid, identical to the JAX package's; each time shard's part
    equals the port's unsharded rx_fast over that block and its halo."""
    x, frames = long_capture
    x2 = np.concatenate([x, np.roll(x, 777, axis=1)])
    want = grid_j(mesh_j.make_mesh({"ch": 2, "time": 2}), jnp.asarray(x2),
                  max_frames_per_shard=6, estimate_cfo_flag=False)
    got = par.rx_grid_sharded(cpu_mesh({"ch": 2, "time": 2}), x2,
                              max_frames_per_shard=6,
                              estimate_cfo_flag=False)
    _same_grid(got, want, x2)
    assert int(got["n"]) == 2 * len(frames)
    half = x2.shape[1] // 2
    head = rx_fast(torch.from_numpy(x2[:, :half + sharded_t.HALO_SAMPLES]),
                   max_frames=6, estimate_cfo_flag=False)
    for k in ("frames", "metrics", "sync_q"):
        assert torch.equal(got[k][:, :6], head[k]), k


def test_rx_grid_sharded_takes_placed_blocks(long_capture):
    """Blocks already on their shards (what the grid stream passes) give
    what the whole array gives; a grid that does not divide raises."""
    x, _ = long_capture
    x2 = np.concatenate([x, x])
    mesh = cpu_mesh({"ch": 2, "time": 2})
    blocks = sharded_t.shard_blocks(mesh, x2)
    assert sorted(blocks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    a = par.rx_grid_sharded(mesh, blocks, max_frames_per_shard=6,
                            estimate_cfo_flag=False)
    b = par.rx_grid_sharded(mesh, x2, max_frames_per_shard=6,
                            estimate_cfo_flag=False)
    for k in GRID_KEYS:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="do not split"):
        sharded_t.shard_blocks(mesh, x2[:, :-1])
