"""The PyTorch port imports neither jax nor the JAX package, and importing
it needs no GPU toolchain (kernels build at their first CUDA call, never at
import).  Its import surface is the JAX package's: the top level's lazy
names and the re-exports of core/, rx/ and tx/."""

import subprocess
import sys
import textwrap

import pytest

MODULES = [
    "opv_tpu_torch",
    "opv_tpu_torch.config",
    "opv_tpu_torch.core",
    "opv_tpu_torch.rx",
    "opv_tpu_torch.tx",
    "opv_tpu_torch.core.base40",
    "opv_tpu_torch.core.lfsr",
    "opv_tpu_torch.core.interleave",
    "opv_tpu_torch.core.convcode",
    "opv_tpu_torch.core.framing",
    "opv_tpu_torch.tx.modulator",
    "opv_tpu_torch.tx.multiplexer",
    "opv_tpu_torch.rx.sync",
    "opv_tpu_torch.rx.viterbi",
    "opv_tpu_torch.rx.frame_decoder",
    "opv_tpu_torch.rx.cfo",
    "opv_tpu_torch.rx.fast",
    "opv_tpu_torch.rx.locked",
    "opv_tpu_torch.rx.channelizer",
    "opv_tpu_torch.rx.demod",
    "opv_tpu_torch.rx.pipeline",
    "opv_tpu_torch.rx.coherent",
    "opv_tpu_torch.ops.build",
    "opv_tpu_torch.ops.viterbi",
    "opv_tpu_torch.ops.symbol_soft",
    "opv_tpu_torch.ops.registry",
    "opv_tpu_torch.ops.phase_track",
    "opv_tpu_torch.ops.track_symbols",
    "opv_tpu_torch.ops.sync_scan",
    "opv_tpu_torch.stream",
    "opv_tpu_torch.stream.locked",
    "opv_tpu_torch.stream.multichannel",
    "opv_tpu_torch.stream.state",
    "opv_tpu_torch.stream.wideband",
    "opv_tpu_torch.stream.chunked",
    "opv_tpu_torch.stream.tracking",
    "opv_tpu_torch.stream.sharded",
    "opv_tpu_torch.parallel",
    "opv_tpu_torch.parallel.mesh",
    "opv_tpu_torch.parallel.sharded",
    "opv_tpu_torch.parallel.grid",
    "opv_tpu_torch.parallel.multihost",
    "opv_tpu_torch.entry",
    "opv_tpu_torch.io",
    "opv_tpu_torch.io.iq",
    "opv_tpu_torch.io.udp",
    "opv_tpu_torch.utils",
    "opv_tpu_torch.utils.display",
    "opv_tpu_torch.utils.metrics",
    "opv_tpu_torch.cli",
    "opv_tpu_torch.cli._device",
    "opv_tpu_torch.cli.opv_mod",
    "opv_tpu_torch.cli.opv_demod",
    "opv_tpu_torch.cli.opv_modem",
    "opv_tpu_torch.tools",
    "opv_tpu_torch.tools.capture",
    "opv_tpu_torch.tools.ber_headtohead",
    "opv_tpu_torch.tools.ber_curve",
    "opv_tpu_torch.tools.timing_pin_probe",
    "opv_tpu_torch.tools.gen_timing_template",
    "opv_tpu_torch.tools.timing",
    "opv_tpu_torch.tools.stage_bench",
    "opv_tpu_torch.tools.tx_bench",
    "opv_tpu_torch.tools.wideband_bench",
    "opv_tpu_torch.tools.modem_bench",
    "opv_tpu_torch.tools.scaling_bench",
]


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    r = _run(f"""
        import importlib, sys
        for m in {MODULES!r}:
            importlib.import_module(m)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "opv_tpu",
                                            "tools"))
        assert not bad, bad
        assert "triton" not in sys.modules
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


#: names of opv_tpu's subpackages that the port has no counterpart of
LACKING: dict = {}
#: names the port's subpackages export beyond opv_tpu's (after them)
EXTRA = {"io": ["iq_bytes_to_i16_pairs"]}


def test_top_level_exports_jax_names_lazily():
    """opv_tpu_torch exports opv_tpu's names; importing it loads no
    receiver, and each lazy name is the port's object of that module."""
    import importlib
    import opv_tpu
    import opv_tpu_torch
    assert opv_tpu_torch.__all__ == opv_tpu.__all__
    for name, mod in opv_tpu_torch._LAZY.items():
        assert mod.replace("opv_tpu_torch", "opv_tpu") == opv_tpu._LAZY[name]
        assert getattr(opv_tpu_torch, name) is getattr(
            importlib.import_module(mod), name)
    with pytest.raises(AttributeError):
        opv_tpu_torch.no_such_name
    r = _run("""
        import sys
        import opv_tpu_torch
        assert opv_tpu_torch.CONFIG.samples_per_symbol == 40
        loaded = sorted(m for m in sys.modules if m.startswith("opv_tpu_torch"))
        assert loaded == ["opv_tpu_torch", "opv_tpu_torch.config"], loaded
        assert "torch" not in sys.modules and "jax" not in sys.modules
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


@pytest.mark.parametrize("sub", ["core", "rx", "tx", "io", "parallel",
                                 "stream"])
def test_subpackages_reexport_jax_names(sub):
    """core/, rx/, tx/, io/, parallel/ (its seven names) and stream/
    (ShardedStreamDemodulator among them) re-export opv_tpu's names that
    the port has (then the port's own), each an object of the port's
    module of that subpackage."""
    import importlib
    jax_names = importlib.import_module(f"opv_tpu.{sub}").__all__
    port = importlib.import_module(f"opv_tpu_torch.{sub}")
    lacking = LACKING.get(sub, set())
    assert port.__all__ == [n for n in jax_names if n not in lacking] \
        + EXTRA.get(sub, [])
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith(f"opv_tpu_torch.{sub}."), name


def test_cpu_smoke_of_the_slice_without_jax():
    """The whole slice runs on CPU tensors (the twins) with jax absent."""
    r = _run("""
        import sys
        sys.modules["jax"] = None          # any jax import now fails
        sys.modules["opv_tpu"] = None      # and so does the JAX package
        import numpy as np, torch
        from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
        from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                                modulate_frames, tx_flush_zeros)
        from opv_tpu_torch.rx.locked import rx_locked
        fr = torch.from_numpy(build_bert_frame("W5NYV", frame_num=np.arange(3)))
        iq, _ = modulate_frames(encode_frame(fr))
        s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
        out = rx_locked(s[None], n_frames=3)
        assert bool(out["frame_valid"].all())
        assert torch.equal(out["frames"][0], fr)
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_tracking_receiver_without_jax():
    """The tracking receiver (rx_batch, StreamingDemodulator) runs on CPU
    tensors with jax and opv_tpu absent."""
    r = _run("""
        import sys
        sys.modules["jax"] = None
        sys.modules["opv_tpu"] = None
        import numpy as np, torch
        from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
        from opv_tpu_torch.rx.pipeline import rx_batch
        from opv_tpu_torch.stream import StreamingDemodulator
        from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                                modulate_frames, tx_flush_zeros)
        fr = build_bert_frame("W5NYV", frame_num=np.arange(2))
        iq, _ = modulate_frames(encode_frame(torch.from_numpy(fr)))
        s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()])).to(torch.complex128)
        out = rx_batch(s, device="cpu")
        assert out["decoded"] == 2 and np.array_equal(out["frames"], fr)
        sd = StreamingDemodulator(device="cpu")
        res = sd.feed(s) + sd.flush()
        assert [r[0] for r in res] == [bytes(f) for f in fr]
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_sharded_receivers_without_jax():
    """The sharded engine and the grid stream run on a mesh of CPU entries
    with jax and opv_tpu absent, and emit the unsharded engine's tuples."""
    r = _run("""
        import sys
        sys.modules["jax"] = None
        sys.modules["opv_tpu"] = None
        import numpy as np, torch
        import opv_tpu_torch as opv
        from opv_tpu_torch.parallel import make_mesh
        from opv_tpu_torch.stream import (LockedStreamDemodulator,
                                          ShardedStreamDemodulator)
        from opv_tpu_torch.tx.modulator import iq_int16_to_complex, tx_flush_zeros
        fr = opv.build_bert_frame("W5NYV", frame_num=np.arange(3))
        iq, _ = opv.modulate_frames(opv.encode_frame(torch.from_numpy(fr)))
        s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
        x = torch.stack([s, s.roll(311)])
        mesh = make_mesh({"ch": 2}, devices=["cpu"] * 2)
        a = LockedStreamDemodulator(2, block_frames=1, mesh=mesh)
        b = LockedStreamDemodulator(2, block_frames=1, device="cpu")
        out = a.feed(x) + a.flush()
        assert out == b.feed(x) + b.flush() and len(out) == 6
        sd = ShardedStreamDemodulator(make_mesh({"ch": 1, "time": 2},
                                                devices=["cpu"] * 2), 1)
        res = sd.feed(s[None]) + sd.flush()
        assert [r[1] for r in res] == [bytes(f) for f in fr]
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_dense_and_coherent_receivers_without_jax():
    """rx_fast, MultiChannelDemodulator and rx_batch(coherent=True) run on
    CPU tensors with jax and opv_tpu absent."""
    r = _run("""
        import sys
        sys.modules["jax"] = None
        sys.modules["opv_tpu"] = None
        import numpy as np, torch
        import opv_tpu_torch as opv
        from opv_tpu_torch.tx.modulator import iq_int16_to_complex, tx_flush_zeros
        fr = opv.build_bert_frame("W5NYV", frame_num=np.arange(2))
        iq, _ = opv.modulate_frames(opv.encode_frame(torch.from_numpy(fr)))
        s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
        out = opv.rx_fast(s[None], max_frames=4)
        assert int(out["n_decoded"]) == 2
        mc = opv.MultiChannelDemodulator(1, block_frames=1, device="cpu")
        res = mc.feed(s[None]) + mc.flush()
        assert [r[1] for r in res] == [bytes(f) for f in fr]
        out = opv.rx_batch(s.to(torch.complex128), coherent=True, device="cpu")
        assert out["decoded"] == 0 and int(out["n_symbols"]) == len(s) // 40
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_tools_without_jax():
    """The BER and bench tools run on CPU tensors with jax, opv_tpu and
    the JAX repo's tools/ absent."""
    r = _run("""
        import sys
        for m in ("jax", "opv_tpu", "tools"):
            sys.modules[m] = None
        import torch
        from opv_tpu_torch.tools import ber_curve, ber_headtohead, capture
        from opv_tpu_torch.tools import (modem_bench, scaling_bench,
                                         stage_bench, tx_bench,
                                         wideband_bench)
        rows = ber_curve.sweep([10.0], 2, 42, "locked", "cpu")
        assert rows[0]["frames"] == 2 and rows[0]["ber"] < 0.01
        truth, s, p = capture.exact_signal(2, "cpu")
        sw = capture.wire_to_complex(capture.headtohead_wire(s, p, 42, 10.0, 100))
        row = ber_headtohead.run_locked(sw, truth, "cpu")
        assert row["decoded"] == 2
        cpu = torch.device("cpu")
        rec = stage_bench.bench(1, 2, ["float32"], [4], 1, cpu)
        assert rec["checks"]["passed"] and rec["decoded_per_block"] == 2
        f, bits, _ = wideband_bench.periodic_bits(2, 1, cpu)
        assert bits.shape[0] == (f + 1) * 2168
        assert modem_bench.seq_of(modem_bench.build_frame(77)) == 77
        assert scaling_bench.shard_size(1.0) == 87680
        assert callable(tx_bench.bench)
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_cuda_entry_point_without_cuda_raises():
    """No CPU fallback hides the device: the CUDA wrappers refuse CPU
    tensors, and the registry sends CPU tensors to the twins."""
    import torch
    from opv_tpu_torch.ops import (phase_track, symbol_soft, sync_scan,
                                   track_symbols, viterbi)
    soft = torch.zeros((1, 2144), dtype=torch.int32)
    with pytest.raises(ValueError):
        viterbi.viterbi_r4_cuda(soft)
    with pytest.raises(ValueError):
        viterbi.viterbi_r2_cuda(soft)
    rows = torch.zeros((1, 3, 80))
    with pytest.raises(ValueError):
        symbol_soft.symbol_soft_cuda(rows, torch.zeros((1, 80, 8)),
                                     torch.ones(1), torch.zeros((1, 2, 2)), 2)
    with pytest.raises(ValueError):
        phase_track.phase_track_cuda(torch.zeros(2, dtype=torch.float64),
                                     (0.1, -0.1), 5)
    with pytest.raises(ValueError):
        track_symbols.track_symbols_cuda(
            torch.zeros((1, 64), dtype=torch.complex128),
            torch.tensor([64], dtype=torch.int32),
            torch.zeros((1, 9), dtype=torch.float64), 0.001, 3)
    f64 = torch.zeros((1, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        sync_scan.sync_scan_cuda(f64, f64, f64.bool(),
                                 torch.zeros((1, 6), dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError):
        sync_scan.sync_correlate_scan_cuda(
            torch.zeros((1, 26), dtype=torch.float64), f64.bool(),
            torch.zeros((1, 6), dtype=torch.int32),
            torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError):
        track_symbols.track_symbols_cuda(
            torch.zeros((1, 64), dtype=torch.complex64),
            torch.tensor([64], dtype=torch.int32),
            torch.zeros((1, 9), dtype=torch.float32), 0.001, 3)
    f32 = f64.float()
    with pytest.raises(ValueError):
        sync_scan.sync_scan_cuda(f32, f32, f32.bool(),
                                 torch.zeros((1, 6), dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.float32))
    assert viterbi.viterbi_r4_cuda.launches == 0
    assert phase_track.phase_track_cuda.launches == 0
    assert track_symbols.track_symbols_cuda.launches == {"float64": 0,
                                                         "float32": 0}
    assert sync_scan.sync_scan_cuda.launches == {
        "GivenSync": 0, "SoftSync": 0, "GivenSync,float32": 0,
        "SoftSync,float32": 0}
