"""The port's multi-process execution (opv_tpu_torch/parallel/multihost.py)
on the CPU: two processes join a gloo group through initialize_multihost,
build their mesh with global_mesh (each process's CPU "devices" along
'time'), and run the sharded programs with 'ch' spanning the processes.
Every process must see the single-process run's results: the grid
decode's arrays and the streaming receivers' tuples, on every rank.

The worker is this file run as a script:

    python tests/test_torch_multihost.py worker MODE PID NPROC PORT

MODE grid (tier-1): the (ch=2, time=2) grid decode on 2 x 2 entries, then
the same grid on a mesh whose 'time' axis spans the processes (halos and
the grid stream's window slide then cross over gloo).  The locked engine,
the wideband receiver and the (ch=4, time=2) grid are slow, as
tests/test_multihost.py marks the JAX package's; chip_smoke.py runs their
card counterparts (phase 14 (e)).  Each run has its own timeout, and its
processes are killed when it fails.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: seconds a multi-process run may take
TIMEOUT_S = 110
SPF = 86_720


def free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(mode: str, nproc: int = 2, timeout: int = TIMEOUT_S):
    port = free_tcp_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", mode, str(pid), str(nproc),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(ROOT), env=env) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def check(mode: str, nproc: int = 2):
    for pid, (rc, out, err) in enumerate(run_workers(mode, nproc)):
        assert rc == 0, f"process {pid} failed:\n{out}\n{err[-3000:]}"
        assert f"MULTIHOST {mode} OK pid={pid}" in out, \
            f"process {pid} output:\n{out}\n{err[-2000:]}"


def test_two_process_grid():
    """2 processes x 2 CPU entries, (ch=2, time=2): 'ch' spans the
    processes, 'time' stays in each; then 'time' across them."""
    check("grid")


@pytest.mark.slow
def test_two_process_locked_engine():
    """The locked engine on a ('ch'=4) mesh across 2 processes x 2
    entries: every rank emits the single-process engine's tuples."""
    check("locked")


@pytest.mark.slow
def test_two_process_wideband():
    """WidebandReceiver(4) on a ('ch'=4) mesh across 2 processes: every
    rank emits the single-process receiver's tuples."""
    check("wideband")


@pytest.mark.slow
def test_two_process_ch4_geometry():
    """(ch=4, time=2) over 2 processes x 4 entries: the channel shards
    span and subdivide the processes; distinct frames per channel."""
    check("grid4")


# ------------------------------------------------------------ the worker


def _channels(ch: int, fpc: int = 2):
    """ch channels, each its own BERT frames (numbered 10c...), through
    the port's fast TX on the host."""
    import torch
    from opv_tpu_torch.core import build_bert_frame, encode_frame
    from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                            modulate_frames, tx_flush_zeros)
    out = []
    for c in range(ch):
        frames = build_bert_frame("W5NYV", frame_num=np.arange(fpc) + 10 * c)
        iq, _ = modulate_frames(encode_frame(torch.from_numpy(frames)))
        s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
        out.append((frames, s.numpy()))
    return out


def _grid(pid: int, nproc: int, ch: int, local: int) -> None:
    import torch
    from opv_tpu_torch.parallel import (global_mesh, make_mesh,
                                        rx_grid_sharded)
    from opv_tpu_torch.parallel.mesh import Mesh
    from opv_tpu_torch.stream import ShardedStreamDemodulator

    tdim = local * nproc // ch
    mesh = global_mesh(ch=ch, time=tdim, devices=["cpu"] * local)
    assert mesh.multiprocess and mesh.shape == {"ch": ch, "time": tdim}
    # each process's entries lie along 'time'
    assert all(len(set(row)) == 1 for row in mesh.ranks.tolist())
    per_ch = _channels(ch)
    t = tdim * 87_680
    x = np.zeros((ch, t), np.complex64)
    for c, (_, s) in enumerate(per_ch):
        x[c, :min(t, len(s))] = s[:t]
    got = rx_grid_sharded(mesh, x, max_frames_per_shard=4)
    single = rx_grid_sharded(make_mesh({"ch": ch, "time": tdim},
                                       devices=["cpu"] * (ch * tdim)),
                             x, max_frames_per_shard=4)
    for k in single:
        assert torch.equal(got[k], single[k]), k
    # every transmitted frame owned once (a garbage detection in the flush
    # at the capture's end is owned too, in both packages)
    owned = got["owned"].numpy()
    for c, (frames, _) in enumerate(per_ch):
        mine = [bytes(f) for f in got["frames"][c].numpy()[owned[c]]]
        assert all(mine.count(bytes(f)) == 1 for f in frames), c
    if ch != 2:
        return
    # 'time' across the processes: the halo and the stream's slide go over
    # gloo (a mesh global_mesh would not build)
    cross = Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("ch", "time"),
                 ranks=[[0, 1], [0, 1]])
    got = rx_grid_sharded(cross, x, max_frames_per_shard=4)
    for k in single:
        assert torch.equal(got[k], single[k]), k
    y = np.concatenate([x, np.zeros((ch, 2 * SPF), np.complex64)], axis=1)

    def stream(m):
        sd = ShardedStreamDemodulator(m, channels=ch, max_frames_per_shard=4)
        out = []
        for off in range(0, y.shape[1], 70_001):
            out += sd.feed(y[:, off:off + 70_001])
        return out + sd.flush(), sd.state_tree()

    (want, st1), (out, st2) = stream(make_mesh(
        {"ch": 2, "time": 2}, devices=["cpu"] * 4)), stream(cross)
    assert out == want and len(want) >= 2 * ch, (len(out), len(want))
    assert torch.equal(st1["buf"], st2["buf"])


def _locked(pid: int, nproc: int) -> None:
    from opv_tpu_torch.parallel import global_mesh, make_mesh
    from opv_tpu_torch.stream import LockedStreamDemodulator

    mesh = global_mesh(ch=4, time=1, devices=["cpu"] * 2)
    assert mesh.multiprocess
    frames, s = _channels(1, 4)[0]
    sig = np.zeros((4, len(s) + 4000), np.complex64)
    for c in range(4):
        sig[c, c * 487: c * 487 + len(s)] = s

    def run(**kw):
        sd = LockedStreamDemodulator(channels=4, block_frames=1, **kw)
        cut = sd.window + 12_345
        out = sd.feed(sig[:, :cut]) + sd.feed(sig[:, cut:]) + sd.flush()
        return out, sd

    out, sd = run(mesh=mesh)
    assert sum(p.shape[0] for p in sd._buf.parts) == 4 // nproc
    want, _ = run(mesh=make_mesh({"ch": 4}, devices=["cpu"] * 4))
    assert out == want and len(out) == 4 * len(frames), (len(out), len(want))
    for c in range(4):
        assert [r[1] for r in out if r[0] == c] == [bytes(f) for f in frames]


def _wideband(pid: int, nproc: int) -> None:
    import torch
    from opv_tpu_torch.core import build_bert_frame
    from opv_tpu_torch.parallel import global_mesh, make_mesh
    from opv_tpu_torch.rx.channelizer import (msk_wideband,
                                              synthesize_wideband)
    from opv_tpu_torch.stream import WidebandReceiver

    k = 4
    mesh = global_mesh(ch=k, time=1, devices=["cpu"] * 2)
    sets = {1: build_bert_frame("W5NYV", frame_num=np.arange(3)),
            2: build_bert_frame("TEST", frame_num=np.arange(3) + 6)}
    lead = torch.zeros(2000 * k, dtype=torch.complex128)
    wb = {c: torch.cat([lead, msk_wideband(f, k, device="cpu")])
          for c, f in sets.items()}
    x = synthesize_wideband(wb, k, max(len(v) for v in wb.values()),
                            device="cpu").numpy()

    def run(m):
        rx = WidebandReceiver(k, block_frames=1, mesh=m)
        out, off = rx.feed(x[:rx.window]), rx.window
        while off + rx.quantum <= len(x):
            out += rx.feed(x[off:off + rx.quantum])
            off += rx.quantum
        return out + rx.feed(x[off:]) + rx.flush()

    out = run(mesh)
    assert out == run(make_mesh({"ch": k}, devices=["cpu"] * k))
    for c, frames in sets.items():
        assert [r[1] for r in out if r[0] == c and r[2] <= 16] == \
            [bytes(f) for f in frames]


def worker(mode: str, pid: int, nproc: int, port: int) -> None:
    import torch
    torch.set_num_threads(2)
    from opv_tpu_torch.parallel import initialize_multihost
    initialize_multihost(f"127.0.0.1:{port}", num_processes=nproc,
                         process_id=pid)
    if mode == "grid":
        _grid(pid, nproc, ch=2, local=2)
    elif mode == "grid4":
        _grid(pid, nproc, ch=4, local=4)
    elif mode == "locked":
        _locked(pid, nproc)
    elif mode == "wideband":
        _wideband(pid, nproc)
    else:
        raise ValueError(mode)
    print(f"MULTIHOST {mode} OK pid={pid} nproc={nproc}", flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, str(ROOT))
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
