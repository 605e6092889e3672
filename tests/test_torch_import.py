"""The PyTorch port imports neither jax nor the JAX package, and importing
it needs no GPU toolchain (kernels build at their first CUDA call, never at
import)."""

import subprocess
import sys
import textwrap

import pytest

MODULES = [
    "opv_tpu_torch",
    "opv_tpu_torch.config",
    "opv_tpu_torch.core.base40",
    "opv_tpu_torch.core.lfsr",
    "opv_tpu_torch.core.interleave",
    "opv_tpu_torch.core.convcode",
    "opv_tpu_torch.core.framing",
    "opv_tpu_torch.tx.modulator",
    "opv_tpu_torch.rx.sync",
    "opv_tpu_torch.rx.viterbi",
    "opv_tpu_torch.rx.frame_decoder",
    "opv_tpu_torch.rx.cfo",
    "opv_tpu_torch.rx.fast",
    "opv_tpu_torch.rx.locked",
    "opv_tpu_torch.ops.build",
    "opv_tpu_torch.ops.viterbi",
    "opv_tpu_torch.ops.symbol_soft",
    "opv_tpu_torch.ops.registry",
    "opv_tpu_torch.ops.phase_track",
    "opv_tpu_torch.stream",
    "opv_tpu_torch.stream.locked",
    "opv_tpu_torch.stream.state",
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
                     if k.split(".")[0] in ("jax", "jaxlib", "opv_tpu"))
        assert not bad, bad
        assert "triton" not in sys.modules
        print("ok")
    """)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


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


def test_cuda_entry_point_without_cuda_raises():
    """No CPU fallback hides the device: the CUDA wrappers refuse CPU
    tensors, and the registry sends CPU tensors to the twins."""
    import torch
    from opv_tpu_torch.ops import phase_track, symbol_soft, viterbi
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
    assert viterbi.viterbi_r4_cuda.launches == 0
    assert phase_track.phase_track_cuda.launches == 0
